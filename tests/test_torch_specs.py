"""The port's input specs (``repro_torch.launch.specs``) against the JAX
package's ``launch/specs.py``: for every arch x input shape at the full
config, the meta tensors' shapes and dtypes equal the reference's
``jax.eval_shape`` results (params, the batch or the decode inputs with
the cache, int32 tokens included), and ``variant_for_shape`` gives the
same sliding window."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import get_config as j_config  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro_torch.config import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(1)


def _reference(tree) -> dict:
    """{path names: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
        out[names] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port(tree) -> dict:
    out = {}
    for path, t in tree_leaves_with_path(tree):
        assert t.is_meta, path
        out[tuple(str(k) for k in path)] = (tuple(t.shape),
                                            str(t.dtype)[6:])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_eval_shape(arch):
    jcfg, tcfg = j_config(arch), get_config(arch)
    assert _port(SP.params_specs(tcfg, max_seq=4096)) == _reference(
        JSP.params_specs(jcfg, max_seq=4096))
    for name, shape in INPUT_SHAPES.items():
        jv, tv = JSP.variant_for_shape(jcfg, shape), \
            SP.variant_for_shape(tcfg, shape)
        assert tv.sliding_window == jv.sliding_window, (arch, name)
        got, want = SP.input_specs(tv, shape), JSP.input_specs(jv, shape)
        assert _port(got) == _reference(want), (arch, name)
        if shape.kind == "decode":
            assert got["tokens"].dtype == got["pos"].dtype == torch.int32
        else:
            assert got["tokens"].dtype == torch.int32
    # whisper's learned decoder positions follow max_seq
    if tcfg.family == "audio":
        assert _port(SP.params_specs(tcfg, max_seq=448)) == _reference(
            JSP.params_specs(jcfg, max_seq=448))


def test_long_context_variant_is_the_reference_window():
    long = INPUT_SHAPES["long_500k"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        want = 4096 if cfg.family in ("dense", "moe", "vlm") \
            and not cfg.sliding_window else cfg.sliding_window
        assert SP.variant_for_shape(cfg, long).sliding_window == want
        assert SP.variant_for_shape(cfg, INPUT_SHAPES["train_4k"]) is cfg
