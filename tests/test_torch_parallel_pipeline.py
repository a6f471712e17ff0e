"""The port's pipeline, tensor and sequence parallelism
(``truely_tpu_torch/parallel/pipeline.py``, ``parallel/sharding.py``) on
CPU mesh positions, against the port's sequential or unsharded versions and
the JAX package's (the cases of ``tests/test_pipeline.py``).

- ``pipeline_apply`` is ``torch.equal`` per microbatch to the sequential
  chain (every block sees the same values in the same order);
  ``pipeline_block17`` too, and within float32 tolerance (1e-5 relative,
  2e-6 absolute on activations of magnitude ~5, as the JAX test states)
  of the JAX ``pipeline_block17``.
- ``tp_shard_facenet``'s embeddings equal the unsharded port's within 1e-6
  (a column slice's matmul may round differently from the whole one's) and
  the JAX TP embeddings within 1e-4 (the port-vs-JAX tolerance of
  ``tests/test_torch_models.py``).
- ``sharded_temporal`` equals the unsharded fold exactly, and the JAX
  ``sharded_temporal``: decisions equal, similarities within 1e-6 (as
  ``tests/test_torch_ops.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import random_tree

from truely_tpu.config import DetectorConfig as JDetectorConfig
from truely_tpu.models.inception_resnet_v1 import _init_block17, apply_inception_resnet_v1
from truely_tpu.models.inception_resnet_v1 import init_inception_resnet_v1
from truely_tpu.parallel.mesh import make_mesh as jmake_mesh
from truely_tpu.parallel.pipeline import pipeline_block17 as j_pipeline_block17
from truely_tpu.parallel.sharding import sharded_temporal as j_sharded_temporal
from truely_tpu.parallel.sharding import tp_shard_facenet as j_tp_shard_facenet
from truely_tpu.pipeline.detector import DetectorParams
from truely_tpu_torch.config import DetectorConfig
from truely_tpu_torch.models.weights import params_from_numpy
from truely_tpu_torch.ops.temporal import temporal_consistency
from truely_tpu_torch.parallel.mesh import make_mesh
from truely_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_block17, shard_stage_params, stack_block_params,
)
from truely_tpu_torch.parallel.sharding import (
    ColumnParallelLinear, replicate, sharded_temporal, tp_shard_facenet,
)

torch.set_num_threads(2)


def cpu_mesh(shape, names):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def toy_block(p, x):
    return torch.tanh(x @ p["w"] + p["b"]) + x


def toy_params(seed, n_blocks, d):
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy((rng.normal(size=(d, d)) * 0.3).astype(np.float32)),
             "b": torch.from_numpy((rng.normal(size=(d,)) * 0.1).astype(np.float32))}
            for _ in range(n_blocks)]


def sequential_per_microbatch(params, x, n_micro, block):
    """The chain over each microbatch of the pipeline's row count."""
    outs = []
    for piece in x.chunk(n_micro):
        for p in params:
            piece = block(p, piece)
        outs.append(piece)
    return torch.cat(outs)


def randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 4), (4, 8), (8, 8)])
def test_pipeline_matches_sequential_bitwise(n_stages, n_micro):
    l, d, b = 2 * n_stages, 16, n_micro * 2
    params = toy_params(0, l, d)
    x = randn(1, b, d)
    mesh = cpu_mesh((n_stages,), ("stage",))
    stages = shard_stage_params(mesh, stack_block_params(params))
    out = pipeline_apply(mesh, toy_block, n_microbatches=n_micro)(stages, x)
    assert torch.equal(out, sequential_per_microbatch(params, x, n_micro, toy_block))


def test_pipeline_matches_unsplit_batch_to_ulp():
    params = toy_params(7, 4, 16)
    x = randn(8, 8, 16)
    ref = x
    for p in params:
        ref = toy_block(p, ref)
    mesh = cpu_mesh((2,), ("stage",))
    out = pipeline_apply(mesh, toy_block, n_microbatches=4)(
        shard_stage_params(mesh, stack_block_params(params)), x)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_pipeline_with_data_axis():
    """4-way DP x 2-stage PP: each data row runs its own pipeline on 2 rows,
    microbatches of 1."""
    params = toy_params(2, 4, 8)
    x = randn(3, 8, 8)
    mesh = cpu_mesh((4, 2), ("data", "stage"))
    fn = pipeline_apply(mesh, toy_block, n_microbatches=2, data_axis="data")
    out = fn(shard_stage_params(mesh, stack_block_params(params)), x)
    assert torch.equal(out, sequential_per_microbatch(params, x, 8, toy_block))


def test_pipeline_errors():
    mesh = cpu_mesh((2,), ("stage",))
    with pytest.raises(ValueError, match="do not divide over 2 stages"):
        shard_stage_params(mesh, stack_block_params(toy_params(0, 3, 4)))
    fn = pipeline_apply(mesh, toy_block, n_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        fn(shard_stage_params(mesh, stack_block_params(toy_params(0, 2, 4))), randn(0, 4, 4))


def test_stack_block_params_shapes():
    stacked = stack_block_params(toy_params(6, 6, 4))
    assert stacked["w"].shape == (6, 4, 4) and stacked["b"].shape == (6, 4)
    blocks = params_from_numpy("facenet", random_tree(init_inception_resnet_v1, 2)).repeat_2
    stacked = stack_block_params(list(blocks[:3]))
    assert stacked["branch0.conv.weight"].shape == (3, 128, 896, 1, 1)
    assert stacked["branch1.2.bn.var"].shape == (3, 128)
    assert torch.equal(stacked["conv2d.bias"][1], blocks[1].conv2d.bias)
    stages = shard_stage_params(cpu_mesh((3,), ("stage",)), stacked)
    assert [s[torch.device("cpu")]["conv2d.weight"].shape[0] for s in stages] == [1, 1, 1]


@pytest.fixture(scope="module")
def block17_trees():
    return [random_tree(_init_block17, 10 + i) for i in range(4)]


def port_block17s(trees):
    """Block17 modules with the JAX trees' weights (through a facenet)."""
    from truely_tpu_torch.models.inception_resnet_v1 import Block17
    from truely_tpu_torch.models.weights import _load

    blocks = []
    for i, t in enumerate(trees):
        b = Block17()
        _load(b, t, f"block17_{i}")
        blocks.append(b.eval())
    return blocks


def test_pipeline_block17_bitwise_and_against_jax(block17_trees):
    """tests/test_pipeline.py::test_pipeline_block17_matches_repeat_chain:
    4 blocks over 2 stages, 2 microbatches, 8x8x896 activations."""
    blocks = port_block17s(block17_trees)
    x = randn(5, 4, 8, 8, 896)
    mesh = cpu_mesh((2,), ("stage",))
    stages, fn = pipeline_block17(mesh, blocks, n_microbatches=2)
    with torch.no_grad():
        out = fn(stages, x)
        ref = sequential_per_microbatch(
            blocks, x, 2, lambda b, h: b(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert torch.equal(out, ref)
    jmesh = jmake_mesh((2,), ("stage",), devices=jax.devices()[:2])
    with jax.default_matmul_precision("highest"):
        jstacked, jfn = j_pipeline_block17(
            jmesh, jax.tree_util.tree_map(jnp.asarray, block17_trees), n_microbatches=2)
        jout = np.asarray(jfn(jstacked, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=2e-6 * np.abs(jout).max() / 5)


@pytest.fixture(scope="module")
def facenet_tree():
    return random_tree(init_inception_resnet_v1, 3)


def test_tp_shard_facenet_matches_unsharded_and_jax(facenet_tree):
    """The 1792x512 projection in two column slices (mesh (1, 2)): the
    embeddings of the unsharded port and of the JAX TP-sharded facenet."""
    facenet = params_from_numpy("facenet", facenet_tree)
    mesh = cpu_mesh((1, 2), ("data", "model"))
    tp = tp_shard_facenet(mesh, facenet)
    assert isinstance(tp.last_linear, ColumnParallelLinear)
    assert [tuple(w.shape) for w in tp.last_linear.shards] == [(256, 1792)] * 2
    assert torch.equal(tp.last_linear.full_weight(), facenet.last_linear.weight)
    assert isinstance(facenet.last_linear, torch.nn.Linear)  # the input is not changed
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32))
    with torch.no_grad():
        got, ref = tp(x), facenet(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    # the detector's nets and a training dict take the same split
    assert isinstance(tp_shard_facenet(mesh, {"facenet": facenet})["facenet"].last_linear,
                      ColumnParallelLinear)
    jmesh = jmake_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
    jparams = DetectorParams(mtcnn=None, facenet=jax.tree_util.tree_map(jnp.asarray, facenet_tree),
                             landmark=None)
    jtp = j_tp_shard_facenet(jmesh, jparams)
    with jax.default_matmul_precision("highest"):
        jemb = np.asarray(jax.jit(apply_inception_resnet_v1)(jtp.facenet, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), jemb, atol=1e-4)


def test_replicate_one_copy_per_distinct_device(facenet_tree):
    """Positions on one device share the tree itself; a TP module keeps its
    column slices on the model-axis devices of its replica's position."""
    facenet = params_from_numpy("facenet", facenet_tree)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    reps = replicate(mesh, {"facenet": facenet})
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")]["facenet"] is facenet
    # data row 0 on the CPU, row 1 on the meta device
    rows = make_mesh((2, 2), ("data", "model"), devices=["cpu", "cpu", "meta", "meta"])
    reps = replicate(rows, tp_shard_facenet(rows, facenet))
    assert set(reps) == {torch.device("cpu"), torch.device("meta")}
    cpu, meta = reps[torch.device("cpu")], reps[torch.device("meta")]
    assert meta.conv2d_1a.conv.weight.device.type == "meta"
    assert [w.device.type for w in cpu.last_linear.shards] == ["cpu", "cpu"]
    assert [w.device.type for w in meta.last_linear.shards] == ["meta", "meta"]


def timeline(seed, n=64, dim=32):
    """A timeline whose similarities straddle the threshold (runs form and
    reset), with frames that have no face."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=dim)
    emb = base + rng.normal(size=(n, dim)) * rng.choice([0.01, 0.5], size=(n, 1))
    return emb.astype(np.float32), rng.random(n) > 0.15


@pytest.mark.parametrize("n_sampled", [64, 37, 5])
def test_sharded_temporal_is_exact(n_sampled):
    emb, has_face = timeline(0)
    cfg = DetectorConfig(run_length_threshold=3)
    fn = sharded_temporal(cpu_mesh((4, 1), ("data", "model")), cfg)
    got = fn(torch.from_numpy(emb), torch.from_numpy(has_face), n_sampled)
    with torch.inference_mode():
        ref = temporal_consistency(torch.from_numpy(emb), torch.from_numpy(has_face), n_sampled,
                                   similarity_threshold=cfg.similarity_threshold,
                                   run_length_threshold=3)
    for name in ref._fields:
        if name == "state":
            assert all(torch.equal(a, b) for a, b in zip(got.state, ref.state))
        else:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert int(ref.flagged_count) > 0 or n_sampled < 16
    jmesh = jmake_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
    jres = j_sharded_temporal(jmesh, JDetectorConfig(run_length_threshold=3))(
        jnp.asarray(emb), jnp.asarray(has_face), jnp.int32(n_sampled))
    for name in ("counter", "flagged", "annotated", "has_face"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jres, name)))
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(jres.similarity), atol=1e-6)
    assert (int(got.flagged_count), int(got.final_counter)) == (
        int(jres.flagged_count), int(jres.final_counter))


def test_dryrun_multichip_on_cpu_positions(capsys):
    """One step of every sharded program (train DP x TP, the DP detector
    steps, SP, DP x PP) on four CPU positions, and the module's command on
    one (no model axis, so no pipeline)."""
    from truely_tpu_torch.parallel.dryrun import dryrun_multichip, main

    s = dryrun_multichip(["cpu"] * 4, height=64, width=96)
    assert s["mesh"] == {"data": 2, "model": 2} and s["devices"] == ["cpu"] * 4
    assert np.isfinite(s["train_loss"]) and s["pp_out_norm"] > 0 and s["final_counter"] >= 0
    assert main(["1", "--cpu", "--size", "64x96"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: ") and '"pp_out_norm": null' in line
