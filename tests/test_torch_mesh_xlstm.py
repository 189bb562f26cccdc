"""The ssm family (xLSTM) on a mesh, on the CPU: one 4-rank gloo world
(``repro_torch.launch.mesh.spawn``; the ranks run
tests/mesh_family_ranks.py, which imports no JAX), reduced xlstm-1.3b in
fp32 (2 layers: one unit of an mLSTM and an sLSTM block; 2 heads) under
every preset of the reference on (2, 2) and under ``baseline`` on
(1, 4), where its 2 heads do not divide 4 and every block replicates
over "model", and on (4, 1).

The blocks are cut on whole heads (1 a rank over 2): mLSTM's ``w_up``
holds the rank's heads' main and z columns, ``w_q``, ``w_k`` and
``w_v`` its heads, ``w_if`` and ``w_down`` its heads' channels' rows
(the gates' partials summed in one fp32 all-reduce); sLSTM's
``w_gates`` its heads' columns of each stream, its input and conv
whole, its heads' outputs gathered whole for the SwiGLU ``up`` (341
wide here: it replicates over 2); the conv, ``skip``, ``b_if``,
``r_gates``, ``b_gates`` and the per-head norms' scales replicate and
each rank reads its heads' share.  The state follows the heads and
the rows (the port's departure from the reference's cache rule:
``tests/test_torch_pspec.py::_cache_departure``).

Held against the reference's UNSHARDED steps on the same params
(tests/mesh_family_checks.py states the tolerances): two training
steps, and a prefill and 4 greedy decode steps (fp32 logits within
1e-4, tokens identical); each rank's param and moment slices are the
rule's or a listed departure, its cache leaves the departure's; the
dry-run's ``CountingMesh`` issues each train, prefill and decode step's
collectives kind by kind with their bytes, as the world did."""
import pytest

torch = pytest.importorskip("torch")

import mesh_family_checks as C  # noqa: E402
import mesh_family_ranks as R  # noqa: E402

ARCHS = ("xlstm-1.3b",)
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


def test_the_blocks_join_their_heads_once_a_block(world):
    """Under ``infer-tp`` on (2, 2) (no FSDP, the batch over "data") a
    decode step's collectives over "model" are, per mLSTM block, the
    gates' all-reduce and ``w_down``'s row-parallel sum, per sLSTM
    block the gather of its heads' outputs (its 341-wide SwiGLU
    replicates over 2), and the vocab lookup's join and the logits'
    gather; nothing crosses "data"; the state holds one head a rank."""
    cfg = R.config("xlstm-1.3b")
    units = cfg.n_layers // cfg.xlstm.slstm_every
    mlstm = units * (cfg.xlstm.slstm_every - 1)
    for r in world:
        row = r[("serve", "xlstm-1.3b", "infer-tp_2x2")]
        for kinds in row["kinds"][1:]:
            assert not kinds["data"] and not kinds["mesh"], kinds
            model = kinds["model"]
            assert model["all-reduce"][0] == 2 * mlstm + 1, model
            assert model["all-gather"][0] == units + 1, model
        shapes = row["cache_shapes"]
        assert shapes["mlstm_units/C"][3] == shapes["slstm_units/c"][2] == 1
