"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's ``analysis/roofline.py``: on the same result rows (the
reference's format, and the port's dry-run rows with their collectives
by axis), with the reference module's constants set in the test to the
port's H100 ones and both of the port's link terms (NVLink, network)
set to the reference's one link rate, every row's terms, dominant term,
model FLOPs and ratio are the reference's.  The per-axis split has its
own test: an axis whose group of ranks fits in one 8-GPU node goes over
NVLink, any other over the network."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as JR  # noqa: E402
from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402

torch.set_num_threads(1)
LINK = 100e9


def _rows(tmp_path):
    """Reference-format rows (no collectives by axis), a skipped and an
    error row, and two dry-run rows of the port."""
    from repro_torch.config import get_reduced_config
    from repro_torch.launch.dryrun import dryrun_one
    ref = [dict(arch="smollm-360m", shape=s, mesh="16x16", n_devices=256,
                kind=k, flops_per_device=f, bytes_per_device=b,
                collectives={"total_link_bytes": c},
                params_active=361_821_120)
           for s, k, f, b, c in (
               ("train_4k", "train", 1.7e14, 1.2e13, 4.6e10),
               ("prefill_32k", "prefill", 1.4e14, 4.2e11, 1e12),
               ("decode_32k", "decode", 3.4e10, 3.3e10, 1e6))]
    ref.append({"arch": "zamba2-7b", "shape": "train_4k", "skipped": True,
                "reason": "x"})
    ref.append({"arch": "xlstm-1.3b", "shape": "train_4k", "error": "x"})
    for i, arch in enumerate(("smollm-360m", "qwen3-moe-30b-a3b")):
        res = dryrun_one(arch, "decode_32k" if i else "train_4k",
                         mesh=(2, 2), cfg=get_reduced_config(arch),
                         verbose=False)
        ref.append(json.loads(json.dumps(res)))
    for i, r in enumerate(ref):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    return ref


def test_rows_equal_the_reference_under_the_same_constants(tmp_path,
                                                            monkeypatch):
    rows = _rows(tmp_path)
    monkeypatch.setattr(JR, "PEAK_FLOPS_BF16", MESH.BF16_FLOP_PER_S)
    monkeypatch.setattr(JR, "HBM_BW", MESH.HBM_BYTES_PER_S)
    monkeypatch.setattr(JR, "ICI_BW", LINK)
    monkeypatch.setattr(R, "NVLINK_BYTES_PER_S", LINK)
    monkeypatch.setattr(R, "NETWORK_BYTES_PER_S", LINK)
    got, want = R.load_rows(str(tmp_path)), JR.load_rows(str(tmp_path))
    assert len(got) == len(want) == len(rows) - 2
    for g, w in zip(got, want):
        for k in ("arch", "shape", "mesh", "dominant"):
            assert getattr(g, k) == getattr(w, k)
        for k in ("compute_s", "memory_s", "collective_s",
                  "model_flops_per_dev", "hlo_flops_per_dev",
                  "useful_ratio", "bound_s"):
            assert getattr(g, k) == pytest.approx(getattr(w, k), rel=1e-12)
        # the notes name the port's levers, not the TPU's
        assert "Pallas" not in g.note and "VMEM" not in g.note
    md = R.to_markdown(got)
    assert md.count("\n") == len(got) + 1 and "| bound |" in md


@pytest.mark.parametrize("mesh,axis,nvlink", [
    ("16x16", "model", False), ("16x16", "data", False),
    ("16x16", "mesh", False), ("2x4", "model", True), ("2x4", "data", True),
    ("1x8", "model", True), ("4x4", "data", False), ("4x4", "model", True),
    ("2x2", "mesh", True), ("1x16", "model", False),
    ("2x16x16", "pod", False), ("2x16x16", "pod,data", False),
    ("2x1x2", "pod", True), ("2x2x2", "data,model", True),
    ("2x4x2", "data,model", True), ("2x16x16", "model", False)])
def test_each_axis_takes_its_link(mesh, axis, nvlink):
    assert R.axis_in_node(mesh, axis) == nvlink
    by_axis = {a: {"link_bytes": 0} for a in ("data", "model", "mesh",
                                              axis)}
    by_axis[axis]["link_bytes"] = 9e9
    res = {"mesh": mesh, "collectives_by_axis": by_axis}
    rate = MESH.NVLINK_BYTES_PER_S if nvlink else MESH.NETWORK_BYTES_PER_S
    assert R.collective_s(res) == 9e9 / rate


def test_axes_add_and_constants_are_the_h100s():
    res = {"mesh": "16x16", "collectives_by_axis": {
        "data": {"link_bytes": 5e9}, "model": {"link_bytes": 1e9},
        "mesh": {"link_bytes": 0}}}
    assert R.collective_s(res) == pytest.approx(6e9 / 50e9, rel=1e-12)
    assert (MESH.BF16_FLOP_PER_S, MESH.FP32_FLOP_PER_S,
            MESH.HBM_BYTES_PER_S, MESH.NVLINK_BYTES_PER_S,
            MESH.NETWORK_BYTES_PER_S) == (989e12, 67e12, 3.35e12, 450e9,
                                          50e9)
