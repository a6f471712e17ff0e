"""The port's training step (``truely_tpu_torch/parallel/train.py``) and its
checkpoints (``parallel/checkpoint.py``) against the JAX package's
``make_train_step`` on the same numpy params and batch, at float32 on the
CPU (the cases of ``tests/test_train_checkpoint.py``).

The params are random JAX-layout trees of the JAX nets' shapes
(``random_tree``, made with numpy from a seed; batchnorm's ``mean`` and
``var`` are not the identity, so that their gradients are not trivial).

The JAX gradients of the first step are read from ``make_train_step``'s
own Adam state: after one step its first moment is (1 - b1)·g = 0.1·g.

Tolerances (float32, a full Inception-ResNet-v1 forward and backward):
- the loss and its two parts within 1e-5 relative;
- every leaf's gradient, batchnorm's ``gamma``, ``beta``, ``mean`` and
  ``var`` included, within 1% of the largest gradient of its leaf plus
  1e-3 relative.  Float32 rounding differs between the two packages' conv
  algorithms, and where a pre-activation sits near 0 a ReLU's gate can
  flip, so the up-projections of the residual blocks differ by up to about
  0.7% of their largest gradient; the median leaf by about 0.01%;
- the parameters after 1 and 3 steps within 2·lr a step of the JAX ones,
  and the sign of the port's first update opposite to its gradient's
  wherever |g| > 1e-5.  Adam's first
  step is -lr·g/(|g| + eps): about -lr·sign(g) wherever |g| ≫ eps, so a
  leaf whose gradient is near 1e-8 may move anywhere within lr in either
  package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truely_tpu.models import init_inception_resnet_v1, init_landmark68
from truely_tpu.parallel.train import Batch as JBatch
from truely_tpu.parallel.train import make_train_step as j_make_train_step
from truely_tpu_torch.parallel import checkpoint
from truely_tpu_torch.parallel.mesh import make_mesh
from truely_tpu_torch.parallel.sharding import tp_shard_facenet
from truely_tpu_torch.parallel.train import (
    Batch, make_train_step, numpy_batch, train_params_from_numpy, train_params_to_numpy,
)

torch.set_num_threads(2)

LR = 1e-4


def random_tree(init_fn, seed):
    """A numpy param tree of ``init_fn``'s structure and shapes: weights
    N(0, 2/fan_in), biases and batchnorm shifts small, batchnorm scales
    and variances near 1, PReLU 0.25."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "w":
            return rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        if name in ("gamma", "var"):
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "alpha":
            return np.full(shape, 0.25, np.float32)
        return rng.normal(0, 0.05, shape).astype(np.float32)  # b, beta, mean

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tree():
    return {"facenet": random_tree(init_inception_resnet_v1, 0),
            "landmark": random_tree(init_landmark68, 1)}


def batch_arrays(b=4, seed=0):
    return numpy_batch(np.random.default_rng(seed), b)


def jax_batch(batch):
    return JBatch(*(jnp.asarray(t.numpy()) for t in batch))


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's jitted (init_fn, step_fn), compiled once."""
    return j_make_train_step(learning_rate=LR, compute_dtype=jnp.float32)


def jax_steps(jax_step, tree, n):
    """The metrics and gradients of the first of ``n`` JAX steps from
    ``tree``, and the params after each."""
    init_fn, step_fn = jax_step
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, tree))
    jb = jax_batch(batch_arrays())
    params = []
    with jax.default_matmul_precision("highest"):
        for i in range(n):
            state, m = step_fn(state, jb)
            if i == 0:
                metrics = {k: float(v) for k, v in m.items()}
                grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / np.float32(0.1),
                                               state.opt_state[0].mu)
            params.append(jax.tree_util.tree_map(np.asarray, state.params))
    return metrics, grads, params


@pytest.fixture(scope="module")
def jax_ref(jax_step, tree):
    return jax_steps(jax_step, tree, 3)


def port_steps(tree, n, mesh=None, tp=False, b=4, seed=0):
    init_fn, step_fn = make_train_step(mesh, learning_rate=LR, device="cpu")
    params = train_params_from_numpy(tree)
    if tp:
        params = tp_shard_facenet(mesh, params)
    state = init_fn(params)
    out = []
    for _ in range(n):
        state, metrics = step_fn(state, batch_arrays(b, seed))
        out.append(({k: float(v) for k, v in metrics.items()},
                    train_params_to_numpy(state.params, grads=True),
                    train_params_to_numpy(state.params)))
    return state, out


@pytest.fixture(scope="module")
def port_run(tree):
    return port_steps(tree, 3)


def tree_of(trees):
    return trees["facenet"]


def assert_metrics_close(got, want):
    assert set(got) == set(want) == {"loss", "nce", "landmark_mse"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def assert_grads_close(got, want):
    """Every leaf's gradient within 1% of the leaf's largest plus 1e-3
    relative."""
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-2 * np.abs(b).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def assert_params_close(got, want, steps):
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * steps + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_tree_round_trip(tree):
    """train_params_from_numpy and its inverse: the JAX tree's structure
    and values, and every leaf (batchnorm's too) a parameter."""
    params = train_params_from_numpy(tree)
    back = train_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (_, a), (_, b) in zip(leaves(back), leaves(tree)):
        np.testing.assert_array_equal(a, b)
    n_leaves = len(leaves(tree))
    assert sum(1 for m in params.values() for _ in m.parameters()) == n_leaves
    assert not any(True for m in params.values() for _ in m.buffers())


def test_first_step_loss_and_every_gradient_match_jax(jax_ref, port_run):
    metrics, grads, _ = jax_ref
    got_metrics, got_grads, _ = port_run[1][0]
    assert_metrics_close(got_metrics, metrics)
    assert_grads_close(got_grads, grads)
    bn = [v for p, v in leaves(got_grads["facenet"])
          if p[-1].key in ("gamma", "beta", "mean", "var")]
    n_bn = sum(1 for p, _ in leaves(tree_of(got_grads)) if p[-1].key == "gamma")
    assert n_bn > 70 and len(bn) == 4 * n_bn and all(np.abs(v).max() > 0 for v in bn)


@pytest.mark.parametrize("steps", [1, 3])
def test_params_after_steps_match_jax(tree, jax_ref, port_run, steps):
    _, _, jparams = jax_ref
    _, grads, got = port_run[1][steps - 1]
    assert_params_close(got, jparams[steps - 1], steps)
    if steps == 1:  # the sign of the first update, where |g| is well above eps
        for (path, g), (_, p0), (_, p1) in zip(leaves(grads), leaves(tree), leaves(got)):
            big = np.abs(g) > 1e-5
            np.testing.assert_array_equal(np.sign(p1 - p0)[big], -np.sign(g)[big],
                                          err_msg=jax.tree_util.keystr(path))


def test_loss_decreases_and_steps_count(port_run):
    state, out = port_run
    losses = [m["loss"] for m, _, _ in out]
    assert losses[-1] < losses[0]
    assert state.step == 3


@pytest.fixture(scope="module")
def single_step(tree):
    return port_steps(tree, 1, seed=3)[1]


@pytest.mark.parametrize("shape,tp", [((4, 1), False), ((1, 2), True)])
def test_mesh_step_matches_single_device(tree, single_step, shape, tp):
    """DP on 4 positions (one row a shard: the NT-Xent logits span all
    shards) and TP of the projection over 2, against the single-device
    step: loss, every gradient and the updated params within the
    tolerances above."""
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    _, sharded = port_steps(tree, 1, mesh=mesh, tp=tp, seed=3)
    assert_metrics_close(sharded[0][0], single_step[0][0])
    assert_grads_close(sharded[0][1], single_step[0][1])
    assert_params_close(sharded[0][2], single_step[0][2], 1)


def state_arrays(state):
    """Every value and Adam moment of a state, by net and leaf, on the CPU."""
    out = {}
    for key, m in state.params.items():
        for name, ps in checkpoint._leaves(m).items():
            out[(key, name)] = torch.cat([p.detach() for p in ps])
            moments = [state.opt_state.state[p] for p in ps]
            out[(key, name, "m")] = torch.cat([s["exp_avg"] for s in moments])
            out[(key, name, "v")] = torch.cat([s["exp_avg_sq"] for s in moments])
    return out


def assert_states_equal(a, b):
    x, y = state_arrays(a), state_arrays(b)
    assert set(x) == set(y)
    for k in x:
        assert torch.equal(x[k], y[k]), k


def test_checkpoint_round_trip(tmp_path, tree, port_run):
    """tests/test_train_checkpoint.py::test_checkpoint_roundtrip."""
    state, _ = port_run
    path = checkpoint.save_train_state(str(tmp_path / "ckpt"), state)
    assert path.endswith("step_00000003") and checkpoint.latest_step(str(tmp_path / "ckpt")) == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000003"]
    init_fn, step_fn = make_train_step(learning_rate=LR, device="cpu")
    restored = checkpoint.restore_train_state(str(tmp_path / "ckpt"),
                                              init_fn(train_params_from_numpy(tree)))
    assert restored.step == 3
    assert_states_equal(restored, state)
    # training continues from the restored state
    state2, _ = step_fn(restored, batch_arrays())
    assert state2.step == 4
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "none"), restored)


def test_checkpoint_restores_across_topologies(tmp_path, tree):
    """tests/test_train_checkpoint.py::test_checkpoint_restores_across_topologies:
    a state saved on a 2-position DP mesh restores on 1, and a TP state
    (the projection in two column slices) restores on a single device and
    back, landing on the template's tensors."""
    mesh2 = make_mesh((2, 1), devices=["cpu"] * 2)
    state, _ = port_steps(tree, 1, mesh=mesh2, b=2)
    checkpoint.save_train_state(str(tmp_path / "dp"), state)
    init1, step1 = make_train_step(learning_rate=LR, device="cpu")
    template = init1(train_params_from_numpy(tree))
    restored = checkpoint.restore_train_state(str(tmp_path / "dp"), template)
    assert restored.params["facenet"] is template.params["facenet"]
    assert_states_equal(restored, state)
    assert step1(restored, batch_arrays(2))[0].step == 2

    tp_mesh = make_mesh((1, 2), devices=["cpu"] * 2)
    tp_state, _ = port_steps(tree, 1, mesh=tp_mesh, tp=True, b=2)
    checkpoint.save_train_state(str(tmp_path / "tp"), tp_state)
    single = checkpoint.restore_train_state(str(tmp_path / "tp"),
                                            init1(train_params_from_numpy(tree)))
    assert_states_equal(single, tp_state)
    init_tp, _ = make_train_step(tp_mesh, learning_rate=LR)
    back = checkpoint.restore_train_state(
        str(tmp_path / "tp"), init_tp(tp_shard_facenet(tp_mesh, train_params_from_numpy(tree))))
    assert len(back.params["facenet"].last_linear.shards) == 2
    assert_states_equal(back, tp_state)


def test_trained_weights_load_in_the_jax_package(jax_step, port_run):
    """train_params_to_numpy gives trees the JAX nets take as they are: the
    JAX step from the port's trained params computes the port's loss and
    gradients on them."""
    state, _ = port_run
    trained = train_params_to_numpy(state.params)
    metrics, grads, _ = jax_steps(jax_step, trained, 1)
    _, out = port_steps(trained, 1)
    assert_metrics_close(out[0][0], metrics)
    assert_grads_close(out[0][1], grads)


def test_batch_is_the_jax_batch():
    assert Batch._fields == JBatch._fields
