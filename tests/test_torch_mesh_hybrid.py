"""The hybrid family (zamba2) on a mesh, on the CPU: one 4-rank gloo
world (``repro_torch.launch.mesh.spawn``; the ranks run
tests/mesh_family_ranks.py, which imports no JAX), reduced zamba2 in
fp32 at 3 layers (a unit of two Mamba2 blocks and the shared attention
block, then a tail block) under every preset of the reference on (2, 2)
and under ``baseline`` on (1, 4) and (4, 1).

The Mamba2 blocks are cut on whole SSM heads (16 here: 8 a rank over 2,
4 over 4): ``in_proj`` holds the rank's heads' columns of z, x and dt
with B and C whole, ``out_proj`` its rows; the conv, ``A_log``, ``D``,
``dt_bias`` and the norm's scale replicate and each rank reads its
heads' share; the gated norm over the whole ``d_inner`` sums the ranks'
squares.  The shared block's 4 KV heads do not divide 16, so its cache
is cut on its positions over "seq" and decode merges the ranks'
partials; its adapters replicate over "model".

Held against the reference's UNSHARDED steps on the same params
(tests/mesh_family_checks.py states the tolerances): two training steps
(its ``ssd_chunked`` with the decay mask moved before the exp, as
tests/test_torch_hybrid_training.py holds it: the unmodified reference
gives NaN gradients at this depth, ROADMAP Queue 3 item 6), and a
prefill and 4 greedy decode steps; each rank's param and moment slices
are the rule's, its cache leaves the rule's but the conv window's
channels (the port's departure); the dry-run's ``CountingMesh``
issues each train, prefill and decode step's collectives kind by kind
with their bytes, the norm's all-reduces among them, as the world
did."""
import pytest

torch = pytest.importorskip("torch")

import mesh_family_checks as C  # noqa: E402
import mesh_family_ranks as R  # noqa: E402
from test_torch_hybrid_training import \
    _reference_ssd_masked_before_exp  # noqa: E402

ARCHS = ("zamba2-7b",)
CASES = {name: (arch, shape, preset) for arch in ARCHS
         for name, _, shape, preset in R.cases(arch)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    with _reference_ssd_masked_before_exp():
        return C.reference(ARCHS)


@pytest.fixture(scope="module")
def world(reference):
    return C.world(reference, ARCHS)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_the_unsharded_reference(case, world, reference):
    arch, _, _ = CASES[case]
    C.check_train(world, reference, arch, case)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_rule_slices(case, world):
    arch, shape, preset = CASES[case]
    C.check_slices(world, arch, case, shape, preset)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_unsharded_reference(case, world,
                                                          reference):
    arch, shape, preset = CASES[case]
    C.check_serve(world, reference, arch, case, shape, preset)


@pytest.mark.parametrize("case", list(CASES))
def test_counting_mesh_predicts_the_world_collectives(case, world):
    arch, shape, preset = CASES[case]
    C.check_counting(world, arch, case, shape, preset)


def test_the_mamba2_norm_sums_over_the_heads_axes(world):
    """Under ``infer-tp`` on (2, 2) (no FSDP, the batch over "data") a
    decode step's collectives over "model" are, per Mamba2 block, the
    norm's all-reduce of the ranks' sums of squares and ``out_proj``'s
    row-parallel sum, then the shared block's (the gather of its heads'
    q, k and v, as its cache holds every head on its cut positions, its
    merge's gather, ``w_o``'s and the MLP's sums), and the vocab
    lookup's and the logits' joins; nothing crosses "data"."""
    cfg = R.config("zamba2-7b")
    units, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
    blocks = units * cfg.shared_attn_every + tail
    for r in world:
        for kinds in r[("serve", "zamba2-7b", "infer-tp_2x2")]["kinds"][1:]:
            assert not kinds["data"] and not kinds["mesh"], kinds
            model = kinds["model"]
            assert model["all-reduce"][0] == 2 * blocks + 2 * units + 1, \
                model
            assert model["all-gather"][0] == 2 * units + 1, model
