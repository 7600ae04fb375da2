"""K8 (``ops/f32_gemm.py``, ``csrc/f32_gemm.cu``): f32 products by 3xTF32
on the card's tensor cores, and the tied head that runs through them.

CPU tests: the plain versions (``tied_head_plain`` is ``h @ embed.T``,
with autograd's gradients, in f32 and f64), the shape rule (``takes``),
the dispatch and its counters (CPU tensors go to the plain version;
meta tensors stand for a card's: f64 and short ``h`` are declined, counted
and computed by the plain version, a long f32 ``h`` reaches K8's wrapper;
K8 itself refuses CPU tensors), the split-K rule
(``slice_stages``: f32 sums of at most 256 stages of 32, slices to fill
the SMs), the layout helper ``aligned`` (the same values; one unit
stride, 16-byte rows), and ``_head``/``mlm_logits`` giving the same bits
as the products they replaced.

Card tests (``gpu`` marker; skip here): K8 against an f64 product at the
six shapes of the two training cells' heads (GPT-2-medium: 16384 rows,
d 1024, vocab 50,257; BERT-base: d 768, vocab 30,522; forward h @ E^T,
dh = G @ E, dE = G^T @ h) and at ragged ones (M of 1000 and 3001, not a
multiple of the 128-row tile, with those vocabularies): the largest error
within 1e-4 of the largest entry (the f32 bar), no more than twice that of
torch's f32 matmul (TF32 off) and at least 10x below one TF32 product's,
so the precision is shown, not assumed; tiny odd shapes (every edge
masked) at the f32 bar (with k of a few dozen, one TF32 product's
representation error, ~2^-21 a term, outweighs f32's accumulation, so
the comparison with torch's matmul is made where the cells' k are);
two launches bit-equal; every K8 GEMM kernel on TF32 ``wgmma`` (SASS
``HGMMA ... TF32``); and one small GPT-2-style (bf16 body, f32 head) and
one BERT training step launching K8 three times a step and declining
none, against the same step with the head on torch's matmul. On the
card: ``python -m pytest -m gpu --noconftest -p no:cacheprovider
tests/test_torch_f32_gemm.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import f32_gemm as fg

# (name, M rows of h, d, V): the two cells' heads
CELLS = (("gpt2-medium", 16384, 1024, 50257), ("bert-base", 16384, 768,
                                                30522))
PRODUCTS = ("forward", "dh", "dembed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "-m gpu --noconftest tests/test_torch_f32_gemm.py)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tied_head_plain_is_the_product_and_its_gradients(dtype):
    g = torch.Generator().manual_seed(0)
    h = torch.randn((3, 5, 8), generator=g, dtype=dtype)
    e = torch.randn((11, 8), generator=g, dtype=dtype)
    hl, el = h.clone().requires_grad_(True), e.clone().requires_grad_(True)
    out = fg.tied_head_plain(hl, el)
    assert torch.equal(out, h @ e.T)
    cot = torch.randn((3, 5, 11), generator=g, dtype=dtype)
    dh, de = torch.autograd.grad(out, (hl, el), cot)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(dh, cot @ e, rtol=tol, atol=tol)
    torch.testing.assert_close(
        de, cot.reshape(-1, 11).T @ h.reshape(-1, 8), rtol=tol, atol=tol)


def test_f64_gradcheck_through_the_plain_head():
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 3, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    e = torch.randn((5, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(fg.tied_head, (h, e))


def test_cpu_tensors_take_the_plain_version():
    before = (fg.tied_head_plain.launches, fg.tied_head.launches,
              fg.tied_head.declined)
    for dtype in (torch.float32, torch.float64):
        h = torch.randn((fg.MIN_ROWS, 4), dtype=dtype)
        e = torch.randn((7, 4), dtype=dtype)
        assert torch.equal(fg.tied_head(h, e), h @ e.T)
    assert (fg.tied_head_plain.launches - before[0],
            fg.tied_head.launches - before[1],
            fg.tied_head.declined - before[2]) == (2, 0, 0)
    # K8 itself takes only the card's tensors
    a, b = torch.randn((5, 3)), torch.randn((3, 4))
    with pytest.raises(ValueError, match="unsupported device cpu"):
        fg.f32_gemm(a, b)


@pytest.mark.parametrize("rows,dtype,want", [
    (fg.MIN_ROWS, torch.float32, True),
    (4 * fg.MIN_ROWS, torch.float32, True),
    (fg.MIN_ROWS - 1, torch.float32, False),   # a decode step's few rows
    (1, torch.float32, False),
    (fg.MIN_ROWS, torch.float64, False),       # the gradient checks
    (fg.MIN_ROWS, torch.bfloat16, False),
    (0, torch.float32, False),
])
def test_shape_rule(rows, dtype, want):
    h = torch.empty((rows, 16), dtype=dtype, device="meta")
    e = torch.empty((9, 16), dtype=dtype, device="meta")
    assert fg.takes(h, e) is want
    assert fg.takes(h.reshape(1, rows, 16), e) is want


def test_declined_products_count_and_keep_torch_matmul():
    """Meta tensors stand for the card's: what the rule declines is counted
    and computed by the plain version (torch's matmul); a long f32 h
    reaches K8's wrapper, which takes only CUDA tensors."""
    e = torch.empty((9, 16), device="meta")
    before = (fg.tied_head.declined, fg.tied_head.launches,
              fg.tied_head_plain.launches)
    for h in (torch.empty((2, 16), device="meta"),
              torch.empty((fg.MIN_ROWS, 16), dtype=torch.float64,
                          device="meta")):
        out = fg.tied_head(h, e.to(h.dtype))
        assert out.shape == (h.shape[0], 9)
    assert (fg.tied_head.declined - before[0],
            fg.tied_head.launches - before[1],
            fg.tied_head_plain.launches - before[2]) == (2, 0, 2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fg.tied_head(torch.empty((fg.MIN_ROWS, 16), device="meta"), e)


@pytest.mark.parametrize("m,n,k,slices", [
    (16384, 50257, 1024, 1),    # the LM head's forward: 50,304 tiles
    (16384, 1024, 50257, 7),    # its dh: 1,571 stages in slices of <= 256
    (50257, 1024, 16384, 2),    # its dembed
    (16384, 768, 30522, 4),     # BERT's dh
    (1024, 1024, 4096, 3),      # 64 tiles: sliced to fill 132 SMs
    (128, 128, 200, 1),         # 7 stages: too few to slice
    (77, 129, 33, 1)])
def test_split_k_rule(m, n, k, slices):
    kts = fg.slice_stages(m, n, k, 132)
    stages = -(-k // 32)
    assert kts <= 256 and -(-stages // kts) == slices


@pytest.mark.parametrize("shape,transposed,offset", [
    ((5, 7), False, 0), ((5, 7), True, 0), ((4, 8), False, 0),
    ((4, 8), True, 0), ((4, 8), False, 1), ((1, 3), False, 0),
    ((6, 1), True, 0), ((50, 33), True, 3)])
def test_aligned_keeps_values_and_gives_16_byte_rows(shape, transposed,
                                                      offset):
    m, k = shape
    base = torch.randn(m * k + offset)[offset:]
    a = base.reshape(k, m).T if transposed else base.reshape(m, k)
    got = fg.aligned(a)
    assert torch.equal(got, a)
    got, sm, sk = fg._strides(got)
    assert 1 in (sm, sk)
    lead = sm if sk == 1 else sk
    assert lead % 4 == 0 and got.data_ptr() % 16 == 0
    if offset == 0 and (k if sk == 1 else m) % 4 == 0:
        assert got.data_ptr() == a.data_ptr()  # no copy where none is needed


def test_head_and_mlm_logits_give_the_same_bits_on_cpu():
    from deeplearning4j_tpu_torch.models import bert as pb
    from deeplearning4j_tpu_torch.models import transformer as pt

    for policy in ("strict", "performance"):
        cfg = pt.TransformerConfig(vocab_size=97, d_model=32, n_layers=1,
                                   n_heads=2, d_ff=64, max_len=16,
                                   dtype_policy=policy, seed=3)
        params = pt.init_params(cfg, device="cpu")
        h = torch.randn((2, 16, 32)).to(cfg.compute_dtype)
        h = pt._final_ln(params, h)
        assert torch.equal(pt._head(params, h),
                           h @ params["embed"].to(h.dtype).T)
    cfg = pb.BertConfig(vocab_size=97, d_model=32, n_layers=1, n_heads=2,
                        d_ff=64, max_len=16, mask_token_id=96, seed=3)
    params = pb.init_params(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 96, (2, 16)))
    assert torch.equal(pb.mlm_logits(params, ids, cfg),
                       pb.encode(params, ids, cfg) @ params["embed"].T)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _operands(product, m, d, v, dev, seed=0):
    """(A, B) of one of the head's products, laid out as the head's
    autograd gives them: h [m, d], E [v, d], G [m, v] contiguous."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if product == "forward":
        h = torch.randn((m, d), generator=g).to(dev)
        e = (torch.randn((v, d), generator=g) * 0.02).to(dev)
        return h, e.T
    gg = torch.randn((m, v), generator=g).to(dev)
    if product == "dh":
        return gg, (torch.randn((v, d), generator=g) * 0.02).to(dev)
    return gg.T, torch.randn((m, d), generator=g).to(dev)


def _errors(a, b):
    """(K8, torch f32, one TF32 product): each's largest error against the
    f64 product, of its largest entry."""
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    got = fg.f32_gemm(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        lib = a @ b
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return tuple((x.double() - ref).abs().max().item() / scale
                 for x in (got, lib, tf32))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("rows", [16384, 3001, 1000])
def test_k8_against_f64_at_the_heads_shapes(cell, product, rows):
    dev = _need_card()
    _, _, d, v = cell
    a, b = _operands(product, rows, d, v, dev)
    k8, lib, tf32 = _errors(a, b)
    assert k8 <= 1e-4, (k8, lib, tf32)
    assert k8 <= 2 * lib, (k8, lib, tf32)
    assert 10 * k8 <= tf32, (k8, lib, tf32)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(77, 33, 129), (1, 5, 3), (129, 1, 7),
                                   (130, 70, 1)])
@pytest.mark.parametrize("layout", ["kmajor", "mmajor", "b_nmajor"])
def test_k8_edges_at_the_f32_bar(m, k, n, layout):
    dev = _need_card()
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g)
    if layout == "mmajor":
        a = a.T.contiguous().T
    b = torch.randn((k, n), generator=g)
    if layout != "b_nmajor":
        b = b.T.contiguous().T
    a, b = a.to(dev), b.to(dev)
    k8, _, _ = _errors(a, b)
    assert k8 <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("product", PRODUCTS)
def test_k8_two_launches_give_the_same_bits(product):
    dev = _need_card()
    a, b = _operands(product, 3001, 768, 30522, dev, seed=2)
    assert torch.equal(fg.f32_gemm(a, b), fg.f32_gemm(a, b))


@pytest.mark.gpu
def test_k8_kernels_run_on_tf32_wgmma():
    """Every K8 GEMM kernel (K-major and M-major A) multiplies with TF32
    wgmma (SASS ``HGMMA ... TF32``); the pack pre-pass and the split-K
    sum have no product."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import build

    if build.cuobjdump_path() is None:
        pytest.skip("cuobjdump not found (it comes with the CUDA toolkit): "
                    "the SASS cannot be read on this machine")
    funcs = build.sass_functions(build.sass("f32_gemm"))
    gemm = [t for n, t in funcs.items() if "f32_gemm_kernel" in n]
    assert len(gemm) == 2
    for text in gemm:
        assert any("HGMMA" in line and "TF32" in line
                   for line in text.splitlines())
    assert all(any(k in n for k in ("f32_gemm_kernel", "f32_gemm_pack_kernel",
                                    "f32_gemm_reduce_kernel"))
               for n in funcs)


def _step_errors(run):
    """``run()`` -> (loss, grads) with the head through K8, then with the
    head declined to torch's matmul: K8's launches and declines over the
    first, and each leaf's largest difference of its largest entry."""
    from deeplearning4j_tpu_torch.models import transformer as pt

    before = (fg.tied_head.launches, fg.tied_head.declined)
    loss, grads = run()
    torch.cuda.synchronize()
    counts = (fg.tied_head.launches - before[0],
              fg.tied_head.declined - before[1])
    rows = fg.MIN_ROWS
    try:
        fg.MIN_ROWS = 1 << 40
        want_loss, want = run()
    finally:
        fg.MIN_ROWS = rows
    errs = {name: ((a - b).abs().max()
                   / b.abs().max().clamp_min(1e-30)).item()
            for (name, a), b in zip(pt._named(grads).items(),
                                    pt.tree_leaves(want))}
    return counts, abs(float(loss) / float(want_loss) - 1), errs


@pytest.mark.gpu
@pytest.mark.parametrize("policy,tol", [("performance", 2e-2),
                                        ("strict", 1e-4)])
def test_lm_step_runs_the_head_through_k8(policy, tol):
    """A TransformerLM step at 2 x 1024 tokens (the rule's threshold):
    three K8 launches, none declined; the loss within 1e-5 and every
    gradient within the policy's bar (bf16 body 2e-2, as the card's step
    against the CPU's; strict f32 1e-4) of the same step with the head on
    torch's f32 matmul."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=1001, d_model=64, n_layers=1,
                               n_heads=2, d_ff=128, max_len=1024,
                               dtype_policy=policy, use_flash=True, seed=6)
    params = pt.tree_map(lambda a: a.to(dev),
                         pt.init_params(cfg, device="cpu"))
    ids = np.random.default_rng(1).integers(0, 1001, (2, 1025))
    x, y = (torch.from_numpy(a).to(dev) for a in (ids[:, :-1], ids[:, 1:]))
    assert x.numel() >= fg.MIN_ROWS
    counts, loss_err, errs = _step_errors(lambda: pt.value_and_grad(
        lambda p: pt.loss_fn(p, x, y, cfg), params))
    assert counts == (3, 0)
    assert loss_err <= 1e-5
    assert max(errs.values()) <= tol, errs


@pytest.mark.gpu
def test_bert_step_runs_the_head_through_k8():
    """A BERT MLM step, strict f32, at 4 x 512 positions: three K8
    launches, none declined; the loss within 1e-5 and every gradient
    within 1e-4 of the same step with the head on torch's f32 matmul."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import bert as pb

    cfg = pb.BertConfig(vocab_size=1001, d_model=64, n_layers=1, n_heads=2,
                        d_ff=128, max_len=512, mask_token_id=1000, seed=7)
    params = pb.tree_map(lambda a: a.to(dev),
                         pb.init_params(cfg, device="cpu"))
    ids = np.random.default_rng(2).integers(1, 1000, (4, 512))
    ids[1, 300:] = 0
    x, y, w = (torch.from_numpy(a).to(dev) for a in pb.mask_tokens(
        ids, cfg, np.random.default_rng(cfg.seed)))
    counts, loss_err, errs = _step_errors(lambda: pb.value_and_grad(
        lambda p: pb.mlm_loss(p, x, y, w, cfg), params))
    assert counts == (3, 0)
    assert loss_err <= 1e-5
    assert max(errs.values()) <= 1e-4, errs
