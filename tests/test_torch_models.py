"""The port's nets against the JAX apply functions at float32 on the CPU.

Both packages run the same weights (a numpy-seeded tree of the JAX
structure, converted with ``params_from_numpy``) on the same numpy inputs.  The convolutions sum in a
different order in XLA and in PyTorch's CPU kernels, so outputs agree to
float32 rounding accumulated over the depth of each net: the tolerances
below are a few hundred ulps of the outputs' scale.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from truely_tpu.models import (
    init_inception_resnet_v1, init_landmark68, init_onet, init_pnet, init_rnet,
)
from truely_tpu.models.inception_resnet_v1 import apply_inception_resnet_v1
from truely_tpu.models.landmark68 import apply_landmark68
from truely_tpu.models.mtcnn_nets import apply_onet, apply_pnet, apply_rnet
from truely_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)
HIGH = jax.lax.Precision.HIGHEST
INITS = {"pnet": init_pnet, "rnet": init_rnet, "onet": init_onet,
         "facenet": init_inception_resnet_v1, "landmark68": init_landmark68}


def random_tree(name, seed):
    """A param tree of the JAX net's structure (from ``jax.eval_shape``, so
    no JAX init runs) filled from a numpy seed: He-scaled weights, and
    random batchnorm statistics, PReLU slopes and biases, so that every
    parameter kind affects the outputs."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                out[k] = walk(v)
                continue
            shape = v.shape
            if k == "w":
                a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            elif k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "gamma":
                a = rng.uniform(0.8, 1.2, shape)
            elif k == "alpha":
                a = rng.uniform(0.1, 0.4, shape)
            else:  # beta, mean, b
                a = rng.normal(scale=0.05, size=shape)
            out[k] = a.astype(np.float32)
        return out

    return walk(jax.eval_shape(INITS[name], jax.random.PRNGKey(0)))


def nets(name, seed=0):
    tree = random_tree(name, seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(name, tree)


def run(module, x, **kw):
    with torch.no_grad():
        return module(torch.from_numpy(x), **kw)


@pytest.mark.parametrize("hw", [(31, 47), (64, 64)])
def test_pnet(hw):
    jp, tp = nets("pnet")
    x = np.random.default_rng(1).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    jprob, jreg = apply_pnet(jp, jnp.asarray(x), precision=HIGH)
    prob, reg = run(tp, x)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=2e-6)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=2e-5)
    # The trunk's features through the 1x1 regression head give the grid's reg.
    with torch.no_grad():
        _, feat = tp.trunk(torch.from_numpy(x))
        np.testing.assert_allclose(tp.reg_from_features(feat).numpy(), reg.numpy(), atol=2e-5)


def test_rnet():
    jp, tp = nets("rnet")
    x = np.random.default_rng(2).uniform(-1, 1, (6, 24, 24, 3)).astype(np.float32)
    jprob, jreg = apply_rnet(jp, jnp.asarray(x), precision=HIGH)
    prob, reg = run(tp, x)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=2e-6)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=5e-5)


def test_onet():
    jp, tp = nets("onet")
    x = np.random.default_rng(3).uniform(-1, 1, (5, 48, 48, 3)).astype(np.float32)
    jprob, jreg, jlmk = apply_onet(jp, jnp.asarray(x), precision=HIGH)
    prob, reg, lmk = run(tp, x)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=2e-6)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=5e-5)
    np.testing.assert_allclose(lmk.numpy(), np.asarray(jlmk), atol=5e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_inception_resnet_v1(normalize):
    jp, tp = nets("facenet")
    x = np.random.default_rng(4).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    ref = np.asarray(apply_inception_resnet_v1(jp, jnp.asarray(x), precision=HIGH,
                                               normalize=normalize))
    ours = run(tp, x, normalize=normalize).numpy()
    assert ours.shape == (2, 512)
    # atol 1e-4 on the L2-normalized embedding (cosine sims move ~1e-4 at
    # most); relative on the raw pre-normalization output.
    if normalize:
        np.testing.assert_allclose(ours, ref, atol=1e-4)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


def test_landmark68():
    jp, tp = nets("landmark68")
    x = np.random.default_rng(5).uniform(0, 1, (3, 80, 80, 3)).astype(np.float32)
    ref = np.asarray(apply_landmark68(jp, jnp.asarray(x), precision=HIGH))
    ours = run(tp, x).numpy()
    assert ours.shape == (3, 68, 2)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", ["pnet", "onet", "facenet"])
def test_bf16_close_to_float32(name):
    """The bf16 compute path (the production default) stays near float32."""
    _, tp = nets(name)
    size = {"pnet": 40, "onet": 48, "facenet": 80}[name]
    lo = -1.0 if name != "facenet" else 0.0
    x = np.random.default_rng(6).uniform(lo, 1, (2, size, size, 3)).astype(np.float32)
    f32 = run(tp, x)
    b16 = run(tp, x, dtype=torch.bfloat16)
    a = f32[0] if isinstance(f32, tuple) else f32
    b = b16[0] if isinstance(b16, tuple) else b16
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=0.05)
