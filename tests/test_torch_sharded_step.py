"""The sharded step executed: the reduced internlm2's train, prefill and
decode steps from ``launch/shapes.py`` ``build_step`` run on DTensors
over a real four-rank ``gloo`` group, on a (2, 2) and a (1, 4) mesh of
("data", "model"), against the same steps run with no mesh on the same
weights and inputs (``tests/torch_sharded_ranks.py``, the harness every
family's rank test shares).

These are the code paths that exist only on a mesh of several devices
and that the dry run traces at full width (``sharding/activation.py``:
``splittable`` on values and gradients, ``write_slice`` into a cache
whose sequence is sharded, ``laid_out_as`` on the gradients, the cache
made by ``cache_leaf``; ``layers.gqa_attention``'s head and sequence
layout with the KV heads repeated; the one-hot embedding over a vocab
shard; the gold logit as a masked sum over the vocab). The (1, 4) mesh
puts 2 KV heads on a 4-way model axis, as internlm2-1.8b puts 8 on the
16-way axis of the pod, so its shards split unevenly. The decode step
writes position 40 of a 64-long cache, which falls in the second of the
(2, 2) mesh's sequence shards and the third of the (1, 4) mesh's.

Every value is held at the bf16 bounds of the port's steps against the
reference (``test_torch_launch.py``); each step's update in units of its
lr."""
import pytest

import torch_sharded_ranks as ranks

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("dense_ranks"),
                           [ARCH])[ARCH]


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_train_step_matches_meshless(executed, mesh):
    """Loss, grad norm, every gradient and both moments after the step
    against the meshless step's, each gradient laid out as its param."""
    ranks.check_train(executed[mesh]["train"], (ARCH, mesh, "train"))


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_train_update_in_units_of_lr(executed, mesh):
    """Each param's update against the meshless step's, element by
    element, in units of the step's lr."""
    ranks.check_updates(executed[mesh]["train"], (ARCH, mesh, "train"))


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_prefill_matches_meshless(executed, mesh):
    """The last logits and the whole cache written by ``write_slice``
    into sequence shards equal the meshless prefill's, the K/V laid out
    over the sequence (dim 2)."""
    r = executed[mesh]["prefill"]
    ranks.check_serve(r, (ARCH, mesh), "prefill")
    assert "Shard(dim=2)" in r["placements"]["k"], (mesh, r["placements"])


@pytest.mark.parametrize("mesh", ranks.MESHES)
def test_sharded_decode_in_a_later_shard_matches_meshless(executed, mesh):
    """A decode step at position 40 of 64, in a sequence shard after the
    first: the logits and the whole cache equal the meshless step's, and
    the written position holds the new K/V (not the cache's old
    values)."""
    r = executed[mesh]["decode"]
    ranks.check_serve(r, (ARCH, mesh), "decode")
    assert "Shard(dim=2)" in r["placements"]["k"], (mesh, r["placements"])
