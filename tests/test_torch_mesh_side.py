"""The audio (whisper-tiny) and vlm (qwen2-vl-2b) families on a mesh, on
the CPU: one 4-rank gloo world (``repro_torch.launch.mesh.spawn``; the
ranks run tests/mesh_family_ranks.py, which imports no JAX), both
reduced in fp32, under every preset of the reference on (2, 2) and
under ``baseline`` on (1, 4) and (4, 1), with their side inputs (audio
frames, patch embeddings) cut on their batch rows with the tokens.

Whisper's 2 heads (6 at full width) do not divide 16, so the rule cuts
its self-attention cache and its cross cache ``xk``/``xv`` (96 frames
here, 1500 at full width) on their positions over "seq": the cross
decode runs the decode kernel's plain version with its log-sum-exp on
the rank's frames and merges the ranks' partials, after gathering every
head's q where the weights cut the heads over the same axis.
qwen2-vl's 2 KV heads likewise cut its cache on its positions, and
decode carries M-RoPE's positions from the config's patch count.

Held against the reference's UNSHARDED steps on the same params and
inputs (tests/mesh_family_checks.py states the tolerances): two
training steps, and a prefill and 4 greedy decode steps; each rank's
param and moment slices and cache leaves are the rule's; the dry-run's
``CountingMesh`` issues each train, prefill and decode step's
collectives kind by kind with their bytes, as the world did."""
import pytest

torch = pytest.importorskip("torch")

import mesh_family_checks as C  # noqa: E402
import mesh_family_ranks as R  # noqa: E402

ARCHS = ("whisper-tiny", "qwen2-vl-2b")
CASES = {f"{arch}-{name}": (arch, name, shape, preset) for arch in ARCHS
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
    arch, name, _, _ = CASES[case]
    C.check_train(world, reference, arch, name)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_rule_slices(case, world):
    arch, name, shape, preset = CASES[case]
    C.check_slices(world, arch, name, shape, preset)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_unsharded_reference(case, world,
                                                          reference):
    arch, name, shape, preset = CASES[case]
    C.check_serve(world, reference, arch, name, shape, preset)


@pytest.mark.parametrize("case", list(CASES))
def test_counting_mesh_predicts_the_world_collectives(case, world):
    arch, name, shape, preset = CASES[case]
    C.check_counting(world, arch, name, shape, preset)


def test_the_cross_cache_is_cut_on_its_frames(world):
    """Under ``baseline`` on (2, 2) whisper's cross cache holds its 96
    frames 48 a rank, with both heads (the weights cut them one a rank
    over the same "model" axis), and a decode step gathers over "model"
    per decoder layer: the self-attention's and the cross-attention's
    heads' q (k and v too for the self-attention), and both merges'
    partials; qwen2-vl's cache holds its 40 positions 20 a rank."""
    cfg = R.config("whisper-tiny")
    L = cfg.n_layers
    for r in world:
        rec = r[("serve", "whisper-tiny", "baseline_2x2")]
        xk = rec["cache_shapes"]["dec/xk"]
        assert xk == (L, 2, cfg.n_audio_frames // 2, cfg.n_kv_heads,
                      cfg.resolved_head_dim), xk
        for kinds in rec["kinds"][1:]:
            assert kinds["model"]["all-gather"][0] == 4 * L + 1, kinds
        vlm = r[("serve", "qwen2-vl-2b", "baseline_2x2")]["cache_shapes"]
        assert vlm["blocks/k"][2] == (R.MAX_SEQ + 16) // 2, vlm
