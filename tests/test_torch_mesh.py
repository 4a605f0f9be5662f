"""cmrtpu_torch's mesh (``parallel/mesh.py``) against cmrtpu's, as pure
functions on the test platform's 8 virtual devices, with no process group:

* the data axis without MESH_SHAPE (the largest divisor of BATCHSIZE),
  MESH_SHAPE's (data, model) and its product check with cmrtpu's message;
  a BATCHSIZE that does not divide the ranks raises, naming BATCHSIZE,
  where cmrtpu would idle devices;
* ``initialize_distributed`` is False in both packages without the
  coordinator's environment;
* each rank's rows of a global batch against cmrtpu's ``shard_batch`` on
  1D and 2D (data x model) meshes, and ``local_batch_size``;
* without a process group every collective is the identity (the
  bfloat16 gradient mean is the cast alone).
"""

import re

import jax
import numpy as np
import pytest
import torch

from cmrtpu.parallel import mesh as jax_mesh
from cmrtpu_torch.parallel import mesh as M

DEVICES = 8


@pytest.mark.parametrize("batch", [0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 30])
def test_data_axis_matches_cmrtpu(batch):
    for n in range(1, DEVICES + 1):
        ref = jax_mesh.create_mesh({"BATCHSIZE": batch},
                                   devices=jax.devices()[:n])
        assert M.data_axis_size(batch, n) == ref.shape["data"], n
        assert M.mesh_shape({"BATCHSIZE": batch}, n) == \
            (ref.shape["data"], 1)


@pytest.mark.parametrize("shape", [[8], [4, 2], [2, 4], [1, 8], [8, 1]])
def test_mesh_shape_matches_cmrtpu(shape):
    ref = jax_mesh.create_mesh({"MESH_SHAPE": shape}, devices=jax.devices())
    want = (ref.shape["data"], dict(ref.shape).get("model", 1))
    assert M.mesh_shape({"MESH_SHAPE": shape}, DEVICES) == want
    for rank in range(DEVICES):
        mesh = M.create_mesh({"MESH_SHAPE": shape}, world_size=DEVICES,
                             rank=rank)
        assert (mesh.data, mesh.model) == want and not mesh.distributed
        # the rank sits where cmrtpu's device of the same index sits
        pos = np.argwhere(np.asarray(ref.devices) == jax.devices()[rank])[0]
        assert mesh.block == pos[0]


@pytest.mark.parametrize("shape,n", [([2, 2], 8), ([3], 8), ([2, 1], 1)])
def test_mesh_shape_product_check_matches_cmrtpu(shape, n):
    with pytest.raises(AssertionError) as ref:
        jax_mesh.create_mesh({"MESH_SHAPE": shape}, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        M.create_mesh({"MESH_SHAPE": shape}, world_size=n, rank=0)
    assert str(got.value) == str(ref.value)


def test_batch_not_dividing_the_ranks_raises():
    ref = jax_mesh.create_mesh({"BATCHSIZE": 6}, devices=jax.devices()[:4])
    assert ref.shape["data"] == 3  # cmrtpu idles one device
    with pytest.raises(ValueError, match="BATCHSIZE 6 does not divide the "
                                         "4 ranks"):
        M.create_mesh({"BATCHSIZE": 6}, world_size=4, rank=1)
    assert M.create_mesh({"BATCHSIZE": 8}, world_size=4, rank=3).block == 3


def test_initialize_distributed_without_environment(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert jax_mesh.initialize_distributed() is False
    assert M.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    # torchrun's address alone, without its port, is no coordinator
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert M.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape", [[8], [4, 2], [2, 4]])
def test_rank_rows_match_shard_batch(shape):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    ref = jax_mesh.create_mesh({"MESH_SHAPE": shape}, devices=jax.devices())
    shards = {s.device: s for s in jax_mesh.shard_batch(x, ref)
              .addressable_shards}
    for rank in range(DEVICES):
        mesh = M.create_mesh({"MESH_SHAPE": shape}, world_size=DEVICES,
                             rank=rank)
        rows = M.shard_batch({"x": x, "t": torch.from_numpy(x)}, mesh)
        want = np.asarray(shards[jax.devices()[rank]].data)
        np.testing.assert_array_equal(rows["x"], want)
        np.testing.assert_array_equal(rows["t"].numpy(), want)
        assert M.local_batch_size(16, mesh) == \
            jax_mesh.local_batch_size(16, ref) == want.shape[0]


def test_local_batch_size_raises_like_cmrtpu():
    ref = jax_mesh.create_mesh({"MESH_SHAPE": [4, 2]}, devices=jax.devices())
    with pytest.raises(AssertionError, match=re.escape(
            "BATCHSIZE 6 must divide the data-mesh size 4")):
        jax_mesh.local_batch_size(6, ref)
    mesh = M.create_mesh({"MESH_SHAPE": [4, 2]}, world_size=8, rank=0)
    with pytest.raises(ValueError, match=re.escape(
            "BATCHSIZE 6 must divide the data-mesh size 4")):
        M.local_batch_size(6, mesh)


def test_collectives_are_identities_without_a_group():
    mesh = M.create_mesh({"BATCHSIZE": 4})
    assert (mesh.data, mesh.model, mesh.rank, mesh.distributed) == \
        (1, 1, 0, False)
    x = torch.randn(4, 3, requires_grad=True)
    with M.record_collectives() as calls:
        assert M.gather_batch(x, mesh) is x
        assert M.all_reduce_sum(x, mesh) is x
        assert M.all_agree(True, mesh) and not M.all_agree(False, mesh)
        assert M.any_rank(True) and not M.any_rank(False)
        assert M.mean_over_ranks([x], mesh)[0] is x
        assert M.broadcast_object("run", mesh) == "run"
        M.barrier(mesh)
        M.broadcast_([x], mesh)
        model = torch.nn.Linear(3, 2)
        model(torch.randn(5, 3)).sum().backward()
        before = [p.grad.clone() for p in model.parameters()]
        M.grad_mean_(model, mesh)  # float32: untouched
        assert all(torch.equal(p.grad, g)
                   for p, g in zip(model.parameters(), before))
        M.grad_mean_(model, mesh, torch.bfloat16)  # the cast alone
        assert all(torch.equal(p.grad, g.bfloat16().float())
                   for p, g in zip(model.parameters(), before))
    assert calls == []
    assert M.is_main_process()
