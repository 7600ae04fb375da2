"""The port's Mellum 2 options (GQA, RoPE and YaRN, sliding windows,
RMSNorm, an untied head, SwiGLU experts held here) and the sliding window
of K4, K5 and K7.

On the CPU (tier 1, tiny sizes, no JAX):

  * a tiny Mellum-style ``TransformerLM`` (d 64, 4 layers in the 3 : 1
    sliding : full pattern, 8 query heads over 2 K/V heads of 16, window
    8 over T 32, 16 experts of which 4 are held, top 4) against the plain
    reference ``perfbench/reference/mellum2.py`` on the benchmark's seeded
    weights: the logits in f32 at the port's 1e-4 bar; in f64 (the
    port's compute dtype lifted to f64) the loss at 1e-12, every gradient
    leaf at 1e-12 of its largest entry, the params after one Adam step at
    1e-8 and after two at 2e-6 (see that test for why);
  * the windowed plain attention (K4's and K5's plain versions) and the
    blocked backward ``flash_block_bwd`` against a dense masked softmax
    and autograd in f64 at 1e-10; a window of at least T bit-equal to
    none;
  * YaRN's inverse frequencies and scale against a hand computation of
    the published parameters;
  * the expert layer cut into the shares {0-3}, {4-7}, {8-11}, {12-15}:
    the shares' outputs sum to the uncut layer's, every (token, choice)
    is computed by exactly one share, and ``moe.dropped_rows`` stays 0;
  * every out-of-scope entry point refuses the new options, and an
    ``ExtendedConfig`` that is not the Mellum block is refused;
  * Adam in place gives the functional step's bits.

On the card (``gpu`` marker; ``python -m pytest -m gpu --noconftest
tests/test_torch_mellum.py``): windowed K4/K5 and K7 in bf16 at the
Mellum layer's shape (T 8192, W 1024, D 128, 32 heads) against their
plain versions on the same card inputs (O 2e-2 abs, lse 1e-3 abs, each
gradient within 1e-2 of its largest entry, the kernels' bars), rows with
no visible key exactly O = 0 and lse = -inf, a window of at least T
bit-equal to none, two launches bit-equal, the ``.windowed`` counters; and
the f32 (3xTF32) kernels with a window at 1e-4.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.models import transformer as tm  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.parallel import expert_parallel as ep  # noqa: E402
from perfbench import programs_moe, weights_mellum  # noqa: E402
from perfbench.reference import adam, mellum2  # noqa: E402

F64 = torch.float64
SLIDE, FULL = "sliding_attention", "full_attention"
YARN = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
        "original_max_position_embeddings": 16, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 1.2772588722239782}
TINY = dict(kind="mellum_lm", vocab_size=97, d_model=64, n_layers=4,
            n_heads=8, n_kv_heads=2, head_dim=16, d_ff=32, experts=16,
            experts_held=4, expert_offset=4, top_k=4,
            layer_types=[SLIDE, SLIDE, SLIDE, FULL], sliding_window=8,
            rope={FULL: YARN, SLIDE: {"rope_type": "default",
                                      "rope_theta": 500000}},
            rms_eps=1e-6, max_len=32, dtype_policy="strict",
            use_flash=True, remat="none", learning_rate=1e-3,
            aux_coef=1e-2)


def _tiny(seed=3, dtype=torch.float32, **over):
    model = dict(TINY, **over)
    params = weights_mellum.make(model, seed, torch.device("cpu"))
    params = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dtype))
              for k, v in params.items()}
    cfg = programs_moe.mellum_config(model, seed)
    return model, cfg, params


def _tokens(n=3, t=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (n, t + 1), generator=g)


def _ref_logits(params, tokens, model):
    h, _ = mellum2.trunk(params, tokens, model, torch.matmul)
    return mellum2.rms(h, params["lnf_g"], model["rms_eps"]) \
        @ params["lm_head"].T


@pytest.fixture
def f64_compute(monkeypatch):
    """The port's compute dtype lifted to f64 (its casts keep f64 above
    f32 everywhere else)."""
    monkeypatch.setattr(tm.TransformerConfig, "compute_dtype",
                        property(lambda self: F64))


def test_tiny_mellum_logits_match_the_reference():
    """f32 logits of the whole model at the port's 1e-4 bar: the same
    function in another order of f32 sums (GQA repeated before the
    attention here, grouped in the reference; the experts by index)."""
    model, cfg, params = _tiny()
    x = _tokens()[:, :-1]
    want = _ref_logits(params, x, model)
    got, aux = tm.forward(params, x, cfg)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() < 1e-4
    assert torch.isfinite(aux)


def test_tiny_mellum_gradients_and_adam_match_the_reference(f64_compute):
    """In f64 the two computations differ only by the order of sums (1e-15
    seen): the loss within 1e-12 and every gradient leaf within 1e-12 of
    its largest entry. ``fit``'s Adam takes its bias correction in f32
    (6.4e-6 of each 1e-3 update: 1 - f32(0.999)), so after one step the
    params agree within 1e-8 (6.7e-9 seen); the second step's gradient
    then differs by that much, and Adam divides entries whose gradient is
    below its eps (|g| ~ 1e-8, sqrt(v) ~ 1e-9) by little more than eps,
    so after two steps the bar is 2e-6, 0.2 % of one update (1.0e-6
    seen)."""
    model, cfg, params = _tiny(dtype=F64)
    batch = _tokens()
    x, y = batch[:, :-1], batch[:, 1:]
    loss, grads = tm.value_and_grad(
        lambda p: tm.loss_fn(p, x, y, cfg), params)
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in adam.leaves(params).items()}
    tree = adam.unflatten(live)
    routes = mellum2.routing(tree, x, model, torch.matmul, rows=3)
    firsts = mellum2.first_shares(routes, model["experts"])
    ref = mellum2.loss_of(tree, x, y, model, torch.matmul, firsts,
                          y.numel())
    ref.backward()
    assert abs(float(loss) - float(ref.detach())) < 1e-12
    got = adam.leaves(grads)
    for k, v in live.items():
        scale = max(v.grad.abs().max().item(), 1e-30)
        assert (got[k] - v.grad).abs().max().item() <= 1e-12 * scale, k
    lm = tm.TransformerLM(cfg, device="cpu", params=params)
    ref_p = {k: v.clone() for k, v in adam.leaves(params).items()}
    state = adam.init(ref_p)
    for step in (1, 2):
        lm.fit(x, y)
        live = {k: v.requires_grad_(True) for k, v in ref_p.items()}
        tree = adam.unflatten(live)
        firsts = mellum2.first_shares(
            mellum2.routing(tree, x, model, torch.matmul, rows=3),
            model["experts"])
        mellum2.loss_of(tree, x, y, model, torch.matmul, firsts,
                        y.numel()).backward()
        ref_p = adam.step({k: v.detach() for k, v in live.items()},
                          {k: v.grad for k, v in live.items()}, state, step,
                          model["learning_rate"])
        now = adam.leaves(lm.params)
        for k, v in ref_p.items():
            bar = 1e-8 if step == 1 else 2e-6
            assert (now[k] - v).abs().max().item() <= bar, (step, k)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_in_place_adam_is_the_functional_step(weight_decay):
    """``_adam_update`` with ``in_place`` against the functional step in
    f64 over three steps with a clip: the same operations written into
    the tensors it is given, so the same bits; the functional step leaves
    its inputs as they were."""
    g = torch.Generator().manual_seed(0)
    p = {"W1": torch.randn(5, 3, generator=g, dtype=F64),
         "b": torch.randn(4, generator=g, dtype=F64)}
    q = {k: v.clone() for k, v in p.items()}
    o1 = tm.init_opt_state(p, loss_scaled=False)
    o2 = tm.init_opt_state(q, loss_scaled=False)
    held = [q["W1"], o2["m"]["W1"], o2["v"]["b"]]
    lr = torch.tensor(1e-2, dtype=torch.float32)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g, dtype=F64)
                 for k, v in p.items()}
        before = {k: v.clone() for k, v in p.items()}
        kept = p
        p, o1 = tm._adam_update(p, grads, o1, lr, weight_decay=weight_decay,
                                clip_grad_norm=1.0)
        assert all(torch.equal(kept[k], before[k]) for k in p)
        q, o2 = tm._adam_update(q, grads, o2, lr, weight_decay=weight_decay,
                                clip_grad_norm=1.0, in_place=True)
    assert int(o1["t"]) == int(o2["t"]) == 3
    assert held[0] is q["W1"] and held[1] is o2["m"]["W1"] \
        and held[2] is o2["v"]["b"]
    for k in p:
        assert torch.equal(p[k], q[k])
        for name in ("m", "v"):
            assert torch.equal(o1[name][k], o2[name][k])


def test_adam_writes_in_place_only_where_a_copy_would_not_fit():
    """``_adam_in_place``: never off a CUDA device, whatever the size."""
    assert not tm._adam_in_place({"W": torch.zeros(3, 4)})
    assert not tm._adam_in_place({"W": torch.zeros(2**20)})


@pytest.mark.parametrize("change", [
    dict(rope={FULL: {"rope_type": "default", "rope_theta": 0},
               SLIDE: {"rope_type": "default", "rope_theta": 0}}),
    dict(experts=0, experts_held=0, expert_offset=0, top_k=1),
    dict(n_kv_heads=3),
    dict(layer_types=[SLIDE, FULL]),
    dict(sliding_window=0),
    dict(expert_offset=14),
])
def test_an_extended_config_must_make_the_mellum_block(change):
    """An ``ExtendedConfig`` is the Mellum 2 block: without a rotation,
    without experts, with query heads that no K/V head count divides,
    with layer types that do not name every layer, sliding layers with
    no window, or held experts past the last, it is refused."""
    model, _, _ = _tiny()
    model = dict(model, **change)
    with pytest.raises(ValueError):
        tm.init_params(programs_moe.mellum_config(model, 3), device="cpu")


def test_windowed_plain_attention_and_backward_against_dense():
    g = torch.Generator().manual_seed(5)
    n, t, h, d = 2, 40, 3, 16
    q, k, v = (torch.randn(n, t, h, d, generator=g, dtype=F64,
                           requires_grad=True) for _ in range(3))
    cot = torch.randn(n, t, h, d, generator=g, dtype=F64)
    qi, ki = torch.arange(t)[:, None], torch.arange(t)[None]
    for w in (1, 5, 17):
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d)
        seen = (ki <= qi) & (qi - ki < w)
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
        want = torch.einsum("nhqk,nkhd->nqhd", p, v)
        before = fa.flash_attention_plain.windowed
        got = fa.attention_auto(q, k, v, causal=True, window=w)
        assert fa.flash_attention_plain.windowed == before + 1
        assert (got - want).abs().max().item() < 1e-10
        a = torch.autograd.grad((got * cot).sum(), (q, k, v))
        b = torch.autograd.grad((want * cot).sum(), (q, k, v),
                                retain_graph=True)
        for x, y in zip(a, b):
            assert (x - y).abs().max().item() < 1e-10
        # K5's plain version and its blocked backward at an offset, Tq < Tk
        o5, lse5 = fa.flash_attention_block_plain(
            q[:, 8:], k, v, offset=8, window=w)
        assert (o5 - want[:, 8:]).abs().max().item() < 1e-10
        g5 = fa.flash_block_bwd(q[:, 8:].detach(), k.detach(), v.detach(),
                                None, 8, o5, lse5, cot[:, 8:], window=w)
        r5 = torch.autograd.grad((want[:, 8:] * cot[:, 8:]).sum(),
                                 (q, k, v))
        assert (g5[0] - r5[0][:, 8:]).abs().max().item() < 1e-10
        for x, y in zip(g5[1:], r5[1:]):
            assert (x - y).abs().max().item() < 1e-10
    # a window of at least T is none, bit for bit
    none = fa.flash_attention_plain(q, k, v, causal=True)
    for w in (t, t + 1, 10 * t):
        same = fa.flash_attention_plain(q, k, v, causal=True, window=w)
        assert all(torch.equal(a, b) for a, b in zip(none, same))


def test_yarn_frequencies_and_scale_by_hand():
    """Published full-layer YaRN: theta 5e5, factor 16, 8192 original
    positions, beta_fast 32, beta_slow 1, hd 128: the correction dims are
    floor(128 ln(8192 / (2 pi 32)) / (2 ln 5e5)) = 18 and
    ceil(128 ln(8192 / (2 pi)) / (2 ln 5e5)) = 35; below 18 the default
    frequency, above 35 it over 16, linear between; cos and sin scaled by
    0.1 ln 16 + 1."""
    rope = {FULL: dict(YARN, original_max_position_embeddings=8192),
            SLIDE: {"rope_type": "default", "rope_theta": 500000}}
    model = dict(TINY, head_dim=128, n_heads=4, n_kv_heads=4, rope=rope)
    cfg = programs_moe.mellum_config(model, 0)
    lo = math.floor(128 * math.log(8192 / (2 * math.pi * 32))
                    / (2 * math.log(5e5)))
    hi = math.ceil(128 * math.log(8192 / (2 * math.pi))
                   / (2 * math.log(5e5)))
    assert (lo, hi) == (18, 35)
    want = []
    for i in range(64):
        base = 5e5 ** (-2 * i / 128)
        ramp = min(1.0, max(0.0, (i - lo) / (hi - lo)))
        want.append(base / 16 * ramp + base * (1 - ramp))
    want = torch.tensor(want, dtype=F64)
    for got in (tm.rope_inv_freq(cfg, FULL), mellum2.inv_freq(model, FULL)):
        assert torch.allclose(got, want, rtol=1e-12, atol=0)
    default = torch.tensor([5e5 ** (-2 * i / 128) for i in range(64)],
                           dtype=F64)
    assert torch.allclose(tm.rope_inv_freq(cfg, SLIDE), default, rtol=1e-12)
    assert abs(YARN["attention_factor"] - (0.1 * math.log(16) + 1)) < 1e-15
    cos, sin = tm.rope_tables(cfg, FULL, 4, "cpu")
    assert torch.allclose(cos[0], torch.full((128,), YARN["attention_factor"],
                                             dtype=cos.dtype))
    assert torch.equal(sin[0], torch.zeros(128, dtype=sin.dtype))
    cos_s, _ = tm.rope_tables(cfg, SLIDE, 4, "cpu")
    assert torch.equal(cos_s[0], torch.ones(128, dtype=cos_s.dtype))


def test_expert_shares_sum_to_the_whole_layer():
    """The guide's share test: four cards of an expert-parallel group
    each holding 4 of 16 experts compute parts that add up to the uncut
    layer (what every card computes alike, the router, counted once: the
    aux term is the same on each)."""
    g = torch.Generator().manual_seed(7)
    t, d, f, e, k = 50, 24, 12, 16, 4
    x = torch.randn(t, d, generator=g, dtype=F64)
    wr = torch.randn(d, e, generator=g, dtype=F64)
    w1 = torch.randn(e, d, 2 * f, generator=g, dtype=F64) / 5
    w2 = torch.randn(e, f, d, generator=g, dtype=F64) / 4
    whole, aux, rows = ep.moe_ffn_held(x, wr, w1, w2, top_k_=k)
    assert sum(rows) == t * k
    parts, counted = torch.zeros_like(whole), 0
    for e0 in (0, 4, 8, 12):
        y, a, r = ep.moe_ffn_held(x, wr, w1[e0:e0 + 4], w2[e0:e0 + 4],
                                  top_k_=k, expert_offset=e0)
        parts += y
        counted += sum(r)
        assert torch.equal(a, aux)
    assert counted == t * k  # every (token, choice) once: nothing dropped
    assert (parts - whole).abs().max().item() < 1e-12
    # against a dense loop over every token and choice
    gates = torch.softmax(x @ wr, -1)
    topv, topi = torch.topk(gates, k)
    w = topv / topv.sum(-1, keepdim=True)
    dense = torch.zeros_like(x)
    for i in range(t):
        for j in range(k):
            ex = int(topi[i, j])
            hmid = x[i] @ w1[ex]
            dense[i] += w[i, j] * ((torch.nn.functional.silu(hmid[:f])
                                    * hmid[f:]) @ w2[ex])
    assert (whole - dense).abs().max().item() < 1e-12


class _Unspecified(torch.autograd.Function):
    """``grouped_products`` as the card's grouped GEMM leaves it: rows
    past the last end, and their gradient rows, NaN; the incoming
    gradient's rows past the end unread."""

    @staticmethod
    def forward(ctx, a, b, ends):
        ctx.save_for_backward(a, b, ends)
        out = ep.grouped_products_plain(a, b, ends)
        out[int(ends[-1]):] = float("nan")
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, ends = ctx.saved_tensors
        end = int(ends[-1])
        with torch.enable_grad():
            a_, b_ = a.detach().requires_grad_(), b.detach().requires_grad_()
            out = ep.grouped_products_plain(a_, b_, ends)
            ga, gb = torch.autograd.grad(
                out, (a_, b_), torch.cat([g[:end], torch.zeros_like(g[end:])]))
        ga[end:] = float("nan")
        return ga, gb, None


def test_rows_past_the_held_ones_are_never_read(monkeypatch):
    """The layer reads no row of the grouped products past the held
    pairs, forward or backward: with those rows NaN (as the card's
    grouped GEMM leaves them unwritten) the output, the aux term and every
    gradient are bit for bit those of the plain products (4 of 16 experts
    held from 4: most pairs go elsewhere)."""
    g = torch.Generator().manual_seed(11)
    t, d, f, e, k = 40, 16, 8, 16, 4
    x = torch.randn(t, d, generator=g, dtype=F64)
    wr = torch.randn(d, e, generator=g, dtype=F64)
    w1 = torch.randn(4, d, 2 * f, generator=g, dtype=F64) / 4
    w2 = torch.randn(4, f, d, generator=g, dtype=F64) / 3
    cot = torch.randn(t, d, generator=g, dtype=F64)

    def run():
        leaves = [a.clone().requires_grad_() for a in (x, wr, w1, w2)]
        y, aux, rows = ep.moe_ffn_held(*leaves, top_k_=k, expert_offset=4)
        grads = torch.autograd.grad((y * cot).sum() + aux, leaves)
        return [y, aux, rows, *grads]

    plain = run()
    monkeypatch.setattr(ep, "grouped_products", _Unspecified.apply)
    poisoned = run()
    assert 0 < int(plain[2].sum()) < t * k
    for a, b in zip(plain, poisoned):
        assert torch.isfinite(b.double()).all() and torch.equal(a, b)


def test_the_expert_layer_counts_and_drops_nothing():
    from deeplearning4j_tpu_torch.obs.registry import default_registry

    model, cfg, params = _tiny()
    x = _tokens()[:, :-1]
    before = programs_moe.routed_rows()
    counters = default_registry().snapshot()["counters"]
    assert counters.get("moe.dropped_rows", {"_": 0.0})["_"] == 0.0
    tm.forward(params, x, cfg)
    routed = programs_moe.routed_rows() - before
    # 96 tokens x 4 choices x 4 layers, a quarter of the experts held
    assert 0 < routed < 96 * 4 * 4
    assert programs_moe.dropped_rows() == 0.0


def test_out_of_scope_entry_points_refuse_the_new_options():
    from deeplearning4j_tpu_torch.serving import decode, paged

    model, cfg, params = _tiny()
    lm = tm.TransformerLM(cfg, device="cpu", params=params)
    x = _tokens()[:, :8]
    calls = [
        lambda: lm.generate(x, 2),
        lambda: tm.prefill_cache(params, x, cfg),
        lambda: tm.decode_step(params, {}, x[:, 0], 0, cfg),
        lambda: tm.ring_forward(params, x, cfg, None),
        lambda: tm.make_ring_train_step(cfg, None),
        lambda: tm.make_pipeline_train_step(cfg, object(), n_micro=2),
        lambda: tm.pipeline_forward(params, x, cfg, object(), n_micro=2),
        lambda: tm.make_train_step(cfg, object()),
        lambda: paged.paged_decode_step(params, {}, x[:, 0], x[:, 0], x,
                                        cfg),
        lambda: paged.PagedDecoder(lm, device="cpu"),
        lambda: decode.decode_step_slots(params, {}, x[:, 0], x[:, 0], cfg),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="does not support the options"):
            call()
    # the GPT-2-style config passes
    tm.refuse_extended(tm.TransformerConfig(), "any entry point")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "-m gpu --noconftest tests/test_torch_mellum.py)")
    return torch.device("cuda")


def _qkv(dev, dtype, n=1, t=8192, h=32, d=128, seed=0, tk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, t, h, d)
    q = torch.randn(shape, generator=g, device=dev).to(dtype)
    kv = (n, tk or t, h, d)
    k = torch.randn(kv, generator=g, device=dev).to(dtype)
    v = torch.randn(kv, generator=g, device=dev).to(dtype)
    return q, k, v


@pytest.mark.gpu
def test_windowed_k4_k5_on_card():
    dev = _card()
    q, k, v = _qkv(dev, torch.bfloat16)
    before = fa.flash_attention.windowed
    o, lse = fa.flash_attention(q, k, v, causal=True, window=1024)
    o2, lse2 = fa.flash_attention(q, k, v, causal=True, window=1024)
    assert fa.flash_attention.windowed == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fa.flash_attention_plain(q, k, v, causal=True, window=1024)
    assert (o.float() - ro.float()).abs().max().item() < 2e-2
    assert (lse - rlse).abs().max().item() < 1e-3
    del ro, rlse
    o5, lse5 = fa.flash_attention_block(q, k, v, offset=0, window=1024)
    assert torch.equal(o5, o) and torch.equal(lse5, lse)
    # a window of at least T is no window, bit for bit
    none = fa.flash_attention(q, k, v, causal=True)
    for w in (8192, 9000):
        same = fa.flash_attention(q, k, v, causal=True, window=w)
        assert torch.equal(none[0], same[0]) and torch.equal(none[1],
                                                             same[1])


@pytest.mark.gpu
def test_windowed_k5_rows_without_keys_on_card():
    """Offset -100: rows 0..99 see no key (exactly O = 0, lse = -inf),
    the others their last 64 keys, at a ragged Tq != Tk."""
    dev = _card()
    q, k, v = _qkv(dev, torch.bfloat16, n=2, t=1000, h=4, tk=1100)
    o, lse = fa.flash_attention_block(q, k, v, offset=-100, window=64)
    ro, rlse = fa.flash_attention_block_plain(q, k, v, offset=-100,
                                              window=64)
    assert torch.equal(o[:, :100], torch.zeros_like(o[:, :100]))
    assert torch.isneginf(lse[:, :, :100]).all()
    assert (o.float() - ro.float()).abs().max().item() < 2e-2
    live = torch.isfinite(rlse)
    assert (lse[live] - rlse[live]).abs().max().item() < 1e-3


def _bwd_case(dev, dtype, **kw):
    q, k, v = _qkv(dev, dtype, **kw)
    g = torch.Generator(device=dev).manual_seed(9)
    cot = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    return q, k, v, cot


@pytest.mark.gpu
def test_windowed_k7_on_card():
    dev = _card()
    q, k, v, cot = _bwd_case(dev, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=True, window=1024)
    before = fa.flash_bwd.windowed
    got = fa.flash_bwd(q, k, v, None, 0, o, lse, cot, window=1024)
    again = fa.flash_bwd(q, k, v, None, 0, o, lse, cot, window=1024)
    assert fa.flash_bwd.windowed == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_block_bwd(q, k, v, None, 0, o, lse, cot, window=1024)
    for a, b in zip(got, want):
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() < 1e-2 * top


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 100, 999])
def test_windowed_f32_kernels_on_card(window):
    """3xTF32 with a window, forward and backward, at f32's 1e-4 (of the
    largest entry of the three gradients: at window 1 each row sees only
    itself, P = 1, and dS = P (dP - Dvec) = 0, so dq and dk are rounding
    around 0 while dv = dO)."""
    dev = _card()
    q, k, v, cot = _bwd_case(dev, torch.float32, n=2, t=1000, h=4, d=64)
    o, lse = fa.flash_attention(q, k, v, causal=True, window=window)
    ro, rlse = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert (o - ro).abs().max().item() < 1e-4
    assert (lse - rlse).abs().max().item() < 1e-4
    got = fa.flash_bwd(q, k, v, None, 0, o, lse, cot, window=window)
    want = fa.flash_block_bwd(q, k, v, None, 0, o, lse, cot, window=window)
    top = max(b.abs().max().item() for b in want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() < 1e-4 * top


@pytest.mark.gpu
def test_held_expert_layer_on_card_reads_nothing_back():
    """The held-expert layer at Mellum's widths (d 2304, f 896, 8 of 64
    experts held, top 8) on 4,096 bf16 tokens: forward and backward with
    no read-back to the host (``set_sync_debug_mode("error")``), its
    grouped GEMMs against one ``torch`` product a group (O 2e-2 of the
    largest entry, gradients 1e-2), and two runs bit-equal."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    t, d, f, e, held, k = 4096, 2304, 896, 64, 8, 8
    bf = torch.bfloat16
    x = torch.randn(t, d, generator=g, device=dev).to(bf)
    wr = torch.randn(d, e, generator=g, device=dev) * (2 / (d + e)) ** 0.5
    w1 = torch.randn(held, d, 2 * f, generator=g, device=dev) * 0.02
    w2 = torch.randn(held, f, d, generator=g, device=dev) * 0.02
    cot = torch.randn(t, d, generator=g, device=dev).to(bf)

    def run():
        leaves = [a.clone().requires_grad_() for a in (x, wr, w1, w2)]
        y, aux, rows = ep.moe_ffn_held(*leaves, top_k_=k)
        grads = torch.autograd.grad((y.float() * cot.float()).sum() + aux,
                                    leaves)
        return [y, aux, rows, *grads]

    run()  # warm: the first call builds what it needs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    grouped = ep.grouped_products
    try:
        ep.grouped_products = ep.grouped_products_plain
        want = run()
    finally:
        ep.grouped_products = grouped
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 0
    assert (got[1] - want[1]).abs().item() < 1e-6
    for a, b, bar in zip(got[:1] + got[3:], want[:1] + want[3:],
                         (2e-2, 1e-2, 1e-2, 1e-2, 1e-2)):
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() < bar * top
