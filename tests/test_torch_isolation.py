"""The port stands alone: it imports neither JAX nor the JAX package,
nor ``msgpack`` or ``zstandard`` (the card's machine lacks zstandard
and does not promise msgpack; the checkpoint store carries its own
MessagePack and writes raw leaves without zstd), its entry points never fall back to the CPU on their own,
and on CPU tensors the kernel dispatch runs the plain PyTorch versions
without counting a launch."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys, tempfile, os
sys.modules["jax"] = None          # any 'import jax' now raises
sys.modules["msgpack"] = None      # not promised on the card's machine
sys.modules["zstandard"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
print(len(names), leaked, " ".join(names))
assert not leaked, leaked
import torch
from repro_torch.checkpoint import store
from repro_torch.serving import paging
assert store.zstd is None and paging.zstd is None
tree = {"a": {"w": torch.randn(3, 5).to(torch.bfloat16)},
        "ids": torch.arange(4, dtype=torch.int32)}
path = os.path.join(tempfile.mkdtemp(), "x.ckpt")
store.save_checkpoint(path, tree, meta={"k": [1, 2.5, "s", None, True]})
leaves, meta = store.load_checkpoint_raw(path)
assert meta == {"k": [1, 2.5, "s", None, True]}, meta
assert torch.equal(leaves["a/w"].view(torch.int16),
                   tree["a"]["w"].view(torch.int16))
assert torch.equal(leaves["ids"], tree["ids"])
back, _ = store.load_checkpoint(path, tree)
assert torch.equal(back["ids"], tree["ids"])
print("checkpoint round trip without msgpack and zstandard: ok")
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 44, out.stdout     # every submodule was imported
    for name in ("models.flash", "kernels.flash_attention",
                 "kernels.decode_attention", "models.ssm", "kernels.ssm_scan",
                 "configs.zamba2_7b", "kernels.int8_quant", "core.cascade",
                 "core.classifier", "core.tiling", "core.filtering",
                 "core.telemetry", "core.link", "core.energy", "data.eo",
                 "training.optim", "core.faults", "serving.scheduler",
                 "checkpoint.store", "checkpoint.msgpack_codec", "tree"):
        assert f"repro_torch.{name}" in out.stdout, out.stdout
    assert "round trip without msgpack and zstandard: ok" in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.config import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ContinuousEngine, ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--continuous"]):     # fixed-slot, then continuous
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--reduced", "--batch", "1", "--max-seq", "32",
                        *extra])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine.init(get_reduced_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.init(get_reduced_config("smollm-360m"))
    for engine in (ServingEngine, ContinuousEngine):     # the hybrid path
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.init(get_reduced_config("zamba2-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-7b", "--reduced", "--batch", "1",
                    "--max-seq", "32"])
    # the EO path: the cascade, the classifiers and their training
    from repro_torch.core import classifier as CL
    from repro_torch.core.cascade import CollaborativeEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CollaborativeEngine(lambda b: b, lambda b: b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CL.init_classifier(CL.ONBOARD)
    tiles = np.zeros((4, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CL.train_classifier(CL.ONBOARD, tiles, np.zeros(4, np.int64),
                            steps=1)


def test_cpu_dispatch_uses_plain_versions_and_counts_no_launch():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((3, 4, 48)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((7, 16, 2, 48))
                               .astype(np.float32)) for _ in range(2))
    bt = torch.tensor([[1, 2, 0], [3, 4, 5], [0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([20, 41, 1], dtype=torch.int32)
    got = ops.paged_decode_attention(q, kp, vp, bt, lens)
    torch.testing.assert_close(
        got, ref.paged_decode_attention_ref(q, kp, vp, bt, lens),
        atol=0, rtol=0)
    x = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    gate, plain = ops.confidence_gate(x), ref.confidence_gate_ref(x)
    for k in plain:
        torch.testing.assert_close(gate[k], plain[k], atol=0, rtol=0)
    qf, kf, vf = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32))
                  for shape in ((2, 9, 4, 48), (2, 9, 2, 48), (2, 9, 2, 48)))
    torch.testing.assert_close(
        ops.flash_attention(qf, kf, vf, causal=True, window=4),
        ref.flash_attention_ref(qf, kf, vf, causal=True, window=4),
        atol=0, rtol=0)
    torch.testing.assert_close(
        ops.decode_attention(qf[:, 0], kf, vf, lens[:2]),
        ref.decode_attention_ref(qf[:, 0], kf, vf, lens[:2]), atol=0, rtol=0)
    xs, dts, Bs, Cs = (torch.from_numpy(rng.standard_normal(shape)
                                        .astype(np.float32))
                       for shape in ((2, 32, 4, 16), (2, 32, 4), (2, 32, 2, 16),
                                     (2, 32, 2, 16)))
    A = -torch.arange(1.0, 5.0)
    for got, want in zip(ops.ssm_chunk_scan(xs, dts.exp(), A, Bs, Cs, chunk=16),
                         ref.ssm_chunk_scan_ref(xs, dts.exp(), A, Bs, Cs, 16)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    x8 = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    for got, want in zip(ops.int8_quantize(x8), ref.int8_quantize_ref(x8)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ops.launch_counts() == {"paged_decode_attention": 0,
                                   "confidence_gate": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0,
                                   "ssm_chunk_scan": 0,
                                   "int8_quantize": 0}
