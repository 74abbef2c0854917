"""The hybrid family's sharded steps executed: the reduced jamba-v0.1-52b,
2 groups of 4 layers (3 Mamba-2 and 1 attention layer a group, MoE on
every other layer).

Four ``gloo`` ranks (``tests/torch_sharded_ranks.py``): the train step
at ``grad_accum`` 2, ``value_and_grad``, the prefill and a decode at
position 40 of 64 from ``launch/shapes.py`` ``build_step`` on DTensors
(the configs' ``moe_impl``, expert-tensor-parallel
``moe_block_sharded``), on a (2, 2) and a (1, 4) mesh of ("data",
"model"), against the same steps with no mesh on the same weights and
inputs.

Two bf16 programs routing near-ties may pick other experts, so in bf16
the loss is held, the logits and the cache with the meshless step on the
mesh's top-k picks, and the picks' agreement apart (as
``tests/test_torch_moe.py`` holds them against the reference). The
wiring is held in fp32 (every weight cast, the embedding in fp32): loss,
aux loss, every gradient, the moments and each update. There the oracle
on a mesh with ``data`` > 1 is the reference's per-shard aux loss
(``src/repro/models/moe.py`` pmeans each device's own Switch loss): the
meshless loss plus 0.01 x the mean of the aux over each data shard's
rows; on (1, 4), where ``data`` is 1, the meshless step."""
import pytest

import torch_sharded_ranks as ranks

ARCHS = ["jamba-v0.1-52b"]
CASES = [(a, m) for a in ARCHS for m in ranks.MESHES]


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("hybrid_ranks"), ARCHS)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_bf16_train_loss_matches_meshless(executed, arch, mesh):
    """The bf16 step's loss and ``value_and_grad``'s, at LOSS_RTOL."""
    r = executed[arch][mesh]["train"]
    where = (arch, mesh, "train")
    assert r["loss"] < ranks.LOSS_RTOL, (where, "loss", r["loss"])
    assert r["grad_loss"] < ranks.LOSS_RTOL, (where, "loss", r["grad_loss"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_fp32_gradients_match_the_per_shard_aux_oracle(
        executed, arch, mesh):
    """In fp32: loss, aux loss, grad norm, every gradient and both
    moments at FP32_RTOL of each leaf's max (v at twice that), against
    the per-shard aux oracle where ``data`` > 1, else the meshless step;
    each gradient laid out as its param."""
    r = executed[arch][mesh]["train_fp32"]
    where = (arch, mesh, "train_fp32", r["oracle"])
    assert r["oracle"] == ("per-shard aux" if mesh == "2x2" else "meshless")
    for k in ("aux", "grad_aux"):
        assert r[k] < ranks.FP32_RTOL, (where, k, r[k])
    ranks.check_train(r, where, ranks.FP32_RTOL, ranks.FP32_RTOL,
                      ranks.FP32_RTOL)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_fp32_update_in_units_of_lr(executed, arch, mesh):
    """Each param's update of the fp32 step against the oracle's, element
    by element, in units of the step's lr."""
    r = executed[arch][mesh]["train_fp32"]
    ranks.check_updates(r, (arch, mesh, "train_fp32"))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_prefill_on_the_mesh_picks_matches_meshless(
        executed, arch, mesh):
    """The last logits and the cache after the prompt, the meshless step
    on the mesh's picks; the picks of the prefill and the decode agree
    with the meshless step's own on PICKS_AGREE of the (token, layer)
    rows."""
    res = executed[arch][mesh]
    ranks.check_serve(res["prefill"], (arch, mesh), "prefill")
    ranks.check_picks(res, (arch, mesh))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_decode_on_the_mesh_picks_matches_meshless(
        executed, arch, mesh):
    """A decode at position 40 of 64, the meshless step on the mesh's
    picks: the logits, the K/V cache, whose written position holds the
    new K/V, and the conv and SSM states, written whole."""
    ranks.check_serve(executed[arch][mesh]["decode"], (arch, mesh),
                      "decode")
