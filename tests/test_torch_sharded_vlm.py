"""The vlm family's sharded steps executed: the reduced qwen2-vl-7b with
an 8-patch vision prefix (a 2 x 4 grid) and three different M-RoPE
streams, whose lead dim the train step splits into microbatches on
dim 1.

Four ``gloo`` ranks (``tests/torch_sharded_ranks.py``): the train step
at ``grad_accum`` 2, ``value_and_grad``, the prefill and a decode at
position 40 of 64 from ``launch/shapes.py`` ``build_step`` on DTensors,
on a (2, 2) and a (1, 4) mesh of ("data", "model"), against the same
steps with no mesh on the same weights and inputs, at the bf16 bounds of
``tests/torch_sharded_ranks.py``; each step's update in units of its
lr."""
import pytest

import torch_sharded_ranks as ranks

ARCH = "qwen2-vl-7b"


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("vlm_ranks"),
                           [ARCH])[ARCH]


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_train_step_matches_meshless(executed, mesh):
    """Loss, grad norm, every gradient and both moments after the step
    against the meshless step's, each gradient laid out as its param."""
    ranks.check_train(executed[mesh]["train"], (ARCH, mesh, "train"))


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_train_update_in_units_of_lr(executed, mesh):
    """Each param's update against the meshless step's, element by
    element, in units of the step's lr (a zero-initialised leaf whose
    near-zero gradient flips sign moves by 2·lr, never more)."""
    ranks.check_updates(executed[mesh]["train"], (ARCH, mesh, "train"))


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_prefill_matches_meshless(executed, mesh):
    """The last logits and the K/V cache after the vision prefix and
    the text, on the M-RoPE positions."""
    ranks.check_serve(executed[mesh]["prefill"], (ARCH, mesh), "prefill")


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_decode_in_a_later_shard_matches_meshless(executed, mesh):
    """A decode at position 40 of 64, in a later sequence shard: the
    logits and the cache, the written position holding the new K/V."""
    ranks.check_serve(executed[mesh]["decode"], (ARCH, mesh), "decode")
