"""Rules of the PyTorch port as a package.

  * It never imports ``jax`` and nothing of ``deeplearning4j_tpu``: every
    module imports in a fresh interpreter with ``jax`` absent from
    ``sys.modules`` afterwards, and no ``import`` statement in the
    package or in ``chip_smoke.py`` names either.
  * Its entry points (``TransformerLM``, ``PagedDecoder``,
    ``ServingEngine``) run on the card unless given ``device="cpu"``;
    with no card they raise instead of moving to the CPU.
  * Its knob table is a copy of the JAX table's serving entries (same
    names, same defaults), and it builds its kernels from ``csrc/``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")


def _modules():
    out = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'deeplearning4j_tpu' "
            "or m.startswith('deeplearning4j_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "deeplearning4j_tpu"), \
            f"{path} imports {name}"


class TestEntryPointsNeedACardOrCpu:
    @pytest.fixture
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_transformer_lm(self, no_card):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )

        cfg = TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_len=32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(cfg, device="cuda")
        assert TransformerLM(cfg, device="cpu").params["embed"].device \
            == torch.device("cpu")

    def test_decoder_and_engine(self, no_card):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.paged import PagedDecoder

        lm = TransformerLM(TransformerConfig(
            vocab_size=16, d_model=16, n_layers=1, n_heads=2, d_ff=32,
            max_len=32), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedDecoder(lm, n_blocks=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(lm, kv_blocks=8)
        eng = ServingEngine(lm, device="cpu")
        try:  # the arena auto-sizes from the host's memory on the CPU
            assert eng.decoder.n_blocks == 4096
        finally:
            eng.stop()


def test_knob_table_copies_the_jax_entries(monkeypatch):
    from deeplearning4j_tpu.ops import env as jenv

    from deeplearning4j_tpu_torch.ops import env as penv

    assert set(penv.KNOBS) == {
        "DL4J_TPU_SERVE_KV_BLOCK", "DL4J_TPU_SERVE_KV_BLOCKS",
        "DL4J_TPU_SERVE_SLOTS", "DL4J_TPU_SERVE_QUEUE_CAP",
        "DL4J_TPU_SERVE_TIMEOUT_S"}
    for name, k in penv.KNOBS.items():
        assert k.default == jenv.KNOBS[name].default, name
        assert k.kind == jenv.KNOBS[name].kind, name
    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCK", "8")
    monkeypatch.setenv("DL4J_TPU_SERVE_TIMEOUT_S", "junk")
    assert penv.get_int("DL4J_TPU_SERVE_KV_BLOCK") == 8
    assert penv.get_float("DL4J_TPU_SERVE_TIMEOUT_S") == 60.0
    with pytest.raises(penv.KnobError):
        penv.raw("DL4J_TPU_SERVE_KV_BLOK")


def test_engine_reads_the_knobs(monkeypatch):
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCK", "8")
    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCKS", "11")
    monkeypatch.setenv("DL4J_TPU_SERVE_SLOTS", "13")
    monkeypatch.setenv("DL4J_TPU_SERVE_QUEUE_CAP", "3")
    lm = TransformerLM(TransformerConfig(vocab_size=16, d_model=16,
                                         n_layers=1, n_heads=2, d_ff=32,
                                         max_len=32), device="cpu")
    eng = ServingEngine(lm, device="cpu", queue_capacity=5)
    try:
        d = eng.decoder
        assert (d.block_tokens, d.n_blocks, d.lanes, d.queue_cap) == \
            (8, 11, 13, 5)
        assert eng.request_timeout_s == 60.0
    finally:
        eng.stop()


def test_kernel_sources_ship_and_build_flags():
    from deeplearning4j_tpu_torch.ops import build

    for name in ("flash_attention", "paged_attention"):
        src = build.CSRC / f"{name}.cu"
        text = src.read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text
        assert "torch/extension.h" not in text  # plain C interface
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
