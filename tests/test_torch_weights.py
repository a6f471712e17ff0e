"""The port's weight bridge: JAX param trees -> torch modules, the flat
``.npz`` reader, and the seeded init."""

import numpy as np
import pytest
import torch
import jax

from truely_tpu.models import (
    init_inception_resnet_v1, init_landmark68, init_onet, init_pnet, init_rnet,
)
from truely_tpu.models import weights as jweights
from truely_tpu_torch.models import weights as tweights

torch.set_num_threads(2)
INITS = {"pnet": init_pnet, "rnet": init_rnet, "onet": init_onet,
         "facenet": init_inception_resnet_v1, "landmark68": init_landmark68}


def jax_tree(name):
    params, loaded = jweights.load_or_init(name, INITS[name], weights_dir="/nonexistent")
    assert not loaded
    return jax.tree_util.tree_map(np.asarray, params)


def leaves(module, node, path=""):
    """(path, module tensor back in the JAX layout, tree array) for every
    leaf of the tree."""
    if isinstance(node, list):
        for i, v in enumerate(node):
            yield from leaves(module[i], v, f"{path}/{i}")
        return
    keys = set(node)
    if keys <= {"w", "b"}:
        w = module.weight.detach().numpy()
        w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        yield path + "/w", w, node["w"]
        if "b" in node:
            yield path + "/b", module.bias.detach().numpy(), node["b"]
    elif keys == {"gamma", "beta", "mean", "var"}:
        for k in sorted(keys):
            yield f"{path}/{k}", getattr(module, k).numpy(), node[k]
    elif keys == {"alpha"}:
        yield path + "/alpha", module.weight.detach().numpy(), node["alpha"]
    else:
        for k, v in node.items():
            yield from leaves(getattr(module, k), v, f"{path}/{k}")


@pytest.mark.parametrize("name", list(INITS))
def test_every_tensor_round_trips(name):
    tree = jax_tree(name)
    module = tweights.params_from_numpy(name, tree)
    n = 0
    for path, got, want in leaves(module, tree):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    assert n == len(module.state_dict())


@pytest.mark.parametrize("name", ["pnet", "facenet"])
def test_reads_npz_written_by_save_params(tmp_path, name):
    tree = jax_tree(name)
    jweights.save_params(str(tmp_path / f"{name}.npz"), tree)
    module, loaded = tweights.load_or_init(name, str(tmp_path))
    assert loaded
    for path, got, want in leaves(module, tree):
        np.testing.assert_array_equal(got, want, err_msg=path)
    # The reader rebuilds the same nested structure (lists from integer keys).
    back = tweights.load_params(str(tmp_path / f"{name}.npz"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


def test_weights_env_directory(tmp_path, monkeypatch):
    jweights.save_params(str(tmp_path / "rnet.npz"), jax_tree("rnet"))
    monkeypatch.setenv(tweights.WEIGHTS_ENV, str(tmp_path))
    assert tweights.load_or_init("rnet")[1]
    assert not tweights.load_or_init("onet")[1]  # no file: seeded init


def test_shape_mismatch_and_missing_tensor_raise():
    tree = jax_tree("pnet")
    bad = dict(tree, conv1=dict(tree["conv1"], w=np.zeros((3, 3, 3, 11), np.float32)))
    with pytest.raises(ValueError, match="conv1"):
        tweights.params_from_numpy("pnet", bad)
    missing = {k: v for k, v in tree.items() if k != "prelu3"}
    with pytest.raises(ValueError, match="tensors"):
        tweights.params_from_numpy("pnet", missing)


@pytest.mark.parametrize("name", list(INITS))
def test_seeded_init_is_deterministic_with_the_jax_distributions(name):
    a, b = tweights.init_params(name), tweights.init_params(name)
    other = tweights.init_params(name, seed=7)
    for (ka, va), (_, vb), (_, vo) in zip(a.state_dict().items(), b.state_dict().items(),
                                          other.state_dict().items()):
        assert torch.equal(va, vb), ka
    ref = jax_tree(name)
    for path, got, want in leaves(a, ref):
        assert got.shape == want.shape, path
        if path.endswith("/w"):
            fan_in = int(np.prod(want.shape[:-1]))
            assert abs(got.std() / np.sqrt(2.0 / fan_in) - 1.0) < 0.25, path
        else:  # biases, batchnorm and PReLU start at the JAX constants
            np.testing.assert_array_equal(got, want, err_msg=path)
    w_a = next(iter(a.state_dict().values()))
    w_o = next(iter(other.state_dict().values()))
    assert not torch.equal(w_a, w_o)
