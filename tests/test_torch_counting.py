"""The port's parameter counting (``repro_torch.models.counting``,
``ModelConfig.param_count``) against the reference's
(``repro.models.counting.count_params``, ``jax.eval_shape`` over its
init) for every assigned arch at full and reduced size, total and
active: the same integers.  The port counts from ``init_params`` on the
meta device, which allocates nothing."""
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_config as j_config  # noqa: E402
from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models.counting import count_params as j_count  # noqa: E402
from repro_torch.config import (ARCH_IDS, get_config,  # noqa: E402
                                get_reduced_config)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.counting import count_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_the_reference(arch, reduced):
    jcfg = (j_reduced if reduced else j_config)(arch)
    cfg = (get_reduced_config if reduced else get_config)(arch)
    for active in (False, True):
        want = j_count(jcfg, active_only=active)
        assert count_params(cfg, active_only=active) == want, (arch, active)
        assert cfg.param_count(active_only=active) == want
    if cfg.moe is not None:
        assert count_params(cfg, active_only=True) < count_params(cfg)


def test_shapes_come_from_the_meta_device():
    """Full deepseek-v3 (671B params) is counted without a byte."""
    shapes = T.param_shapes(get_config("deepseek-v3-671b"))
    assert all(t.is_meta for t in tree_leaves(shapes))
    assert count_params(get_config("deepseek-v3-671b")) > 6e11


@pytest.mark.parametrize("max_seq", [64, 448])
def test_whisper_counts_its_decoder_positions(max_seq):
    cfg, jcfg = get_config("whisper-tiny"), j_config("whisper-tiny")
    assert count_params(cfg, max_seq=max_seq) == j_count(jcfg,
                                                         max_seq=max_seq)
