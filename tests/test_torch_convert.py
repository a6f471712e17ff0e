"""The port's facenet-pytorch conversion (``models.weights.convert_torch_state_dict``,
``fold_batchnorm``, ``python -m truely_tpu_torch.models.convert``) against
the JAX package's, and the last public names of the port against their JAX
functions.

The state dicts come from the replicas of the upstream modules in
``tests/torch_refs.py`` with seeded random weights, as in
``tests/test_models.py``.  The JAX conversion's templates come from
``jax.eval_shape`` of the ``init_*`` functions, so no JAX init runs.
Tolerances: every converted leaf is equal to the JAX conversion's; the
port's nets on the converted weights agree with the torch replicas within
2e-5 (probabilities, P-Net and R-Net regressions), 1e-3 (O-Net's wide
dense outputs, O(30)) and 5e-4 (unit embeddings), the bounds of
``tests/test_models.py``; a folded net's leaves equal the JAX fold's, and
its embeddings agree with the unfolded net's within 2e-4 (float32
rounding through the depth of the net).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import torch_refs
from tests.test_models import randomize
from truely_tpu import config as jconfig
from truely_tpu.models import init_inception_resnet_v1, init_onet, init_pnet, init_rnet
from truely_tpu.models import weights as jweights
from truely_tpu.models.landmark68 import synthetic_landmark_batch as j_synthetic
from truely_tpu.serve import app as japp
from truely_tpu_torch import config
from truely_tpu_torch.models import convert
from truely_tpu_torch.models.landmark68 import synthetic_landmark_batch
from truely_tpu_torch.models.weights import (
    convert_torch_state_dict, fold_batchnorm, load_params, params_to_numpy,
)
from truely_tpu_torch.serve import app

torch.set_num_threads(2)

REFS = {"pnet": (torch_refs.PNet, init_pnet), "rnet": (torch_refs.RNet, init_rnet),
        "onet": (torch_refs.ONet, init_onet),
        "facenet": (torch_refs.InceptionResnetV1, init_inception_resnet_v1)}
SEEDS = {"pnet": 0, "rnet": 1, "onet": 2, "facenet": 3}


@pytest.fixture(scope="module")
def state_dicts():
    """Seeded random state dicts of the four upstream nets."""
    return {n: randomize(cls(), SEEDS[n]).state_dict() for n, (cls, _) in REFS.items()}


def jax_tree(name, sd):
    template = jax.eval_shape(REFS[name][1], jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jweights.convert_torch_state_dict(template, sd))


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in leaves(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", sorted(REFS))
def test_leaves_equal_the_jax_conversion(state_dicts, name):
    got = leaves(params_to_numpy(convert_torch_state_dict(name, state_dicts[name])))
    want = leaves(jax_tree(name, state_dicts[name]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_numpy_state_dict_and_module_target(state_dicts):
    """numpy values convert as tensors do, into a given module too."""
    sd = {k: v.numpy() for k, v in state_dicts["rnet"].items()}
    from truely_tpu_torch.models.mtcnn_nets import RNet

    module = RNet()
    assert convert_torch_state_dict(module, sd) is module
    a, b = leaves(params_to_numpy(module)), leaves(jax_tree("rnet", state_dicts["rnet"]))
    assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("hw", [(12, 12), (55, 97)])
def test_pnet_matches_torch_ref(state_dicts, hw):
    net = convert_torch_state_dict("pnet", state_dicts["pnet"])
    ref = randomize(torch_refs.PNet(), SEEDS["pnet"])
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        reg_t, prob_t = ref(nchw(x))
        prob, reg = net(torch.from_numpy(x))
    np.testing.assert_allclose(prob.numpy(), prob_t[:, 1].numpy(), atol=2e-5)
    np.testing.assert_allclose(reg.numpy(), reg_t.permute(0, 2, 3, 1).numpy(), atol=2e-5)


def test_rnet_onet_match_torch_refs(state_dicts):
    rng = np.random.default_rng(1)
    rnet = convert_torch_state_dict("rnet", state_dicts["rnet"])
    x = rng.normal(size=(4, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        reg_t, prob_t = randomize(torch_refs.RNet(), SEEDS["rnet"])(nchw(x))
        prob, reg = rnet(torch.from_numpy(x))
    np.testing.assert_allclose(prob.numpy(), prob_t[:, 1].numpy(), atol=2e-5)
    np.testing.assert_allclose(reg.numpy(), reg_t.numpy(), atol=2e-5)
    onet = convert_torch_state_dict("onet", state_dicts["onet"])
    x = rng.normal(size=(4, 48, 48, 3)).astype(np.float32)
    with torch.no_grad():
        reg_t, lmk_t, prob_t = randomize(torch_refs.ONet(), SEEDS["onet"])(nchw(x))
        prob, reg, lmk = onet(torch.from_numpy(x))
    np.testing.assert_allclose(prob.numpy(), prob_t[:, 1].numpy(), atol=2e-5)
    np.testing.assert_allclose(reg.numpy(), reg_t.numpy(), atol=1e-3)
    np.testing.assert_allclose(lmk.numpy(), lmk_t.numpy(), atol=1e-3)


def test_facenet_matches_torch_ref_and_folds(state_dicts):
    """The converted Inception-ResNet-v1 embeds as the replica does; its
    batchnorm fold equals the JAX fold's leaves and embeds as the unfolded
    net within float32 rounding."""
    net = convert_torch_state_dict("facenet", state_dicts["facenet"])
    x = np.random.default_rng(3).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    with torch.no_grad():
        emb_t = randomize(torch_refs.InceptionResnetV1(), SEEDS["facenet"])(nchw(x)).numpy()
        emb = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(emb, emb_t, atol=5e-4)

    folded = fold_batchnorm(net)
    got = leaves(params_to_numpy(folded))
    want = leaves(jax.tree_util.tree_map(
        np.asarray, jweights.fold_batchnorm(jax_tree("facenet", state_dicts["facenet"]))))
    assert got.keys() == want.keys()
    assert "/conv2d_1a/conv/b" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.no_grad():
        emb_f = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(emb_f, emb, atol=2e-4)
    # the original module is left as it was
    assert net.conv2d_1a.conv.bias is None


def test_missing_key_and_bad_shape_raise(state_dicts):
    sd = dict(state_dicts["rnet"])
    del sd["conv1.weight"]
    with pytest.raises(KeyError, match="conv1.weight"):
        convert_torch_state_dict("rnet", sd)
    sd = dict(state_dicts["rnet"])
    sd["dense4.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="dense4.bias"):
        convert_torch_state_dict("rnet", sd)


def test_convert_cli_writes_the_jax_npz(state_dicts, tmp_path):
    """``python -m truely_tpu_torch.models.convert`` writes what the JAX
    package's script writes: the same keys and arrays, read back by both."""
    ckpt = {}
    for name in ("pnet", "onet"):
        sd = dict(state_dicts[name])
        sd["logits.weight"] = torch.zeros(3, 3)   # dropped, as upstream's classifier
        ckpt[name] = str(tmp_path / f"{name}.pt")
        torch.save(sd, ckpt[name])
    out = tmp_path / "w"
    assert convert.main(["--pnet", ckpt["pnet"], "--onet", ckpt["onet"], "--out", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["onet.npz", "pnet.npz"]
    for name in ("pnet", "onet"):
        jax_path = str(tmp_path / f"jax_{name}.npz")
        jweights.save_params(jax_path, jax_tree(name, state_dicts[name]))
        with np.load(out / f"{name}.npz") as a, np.load(jax_path) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])
        got = leaves(load_params(str(out / f"{name}.npz")))
        want = leaves(jweights.load_params(str(out / f"{name}.npz")))
        assert all(np.array_equal(got[k], np.asarray(want[k])) for k in want)


def test_agents_config_equals_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(config.AgentsConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jconfig.AgentsConfig)]
    assert got == want


def test_create_app_builds_the_server():
    det = object()
    server = app.create_app(config=config.ServerConfig(port=5999), detector=det)
    assert isinstance(server, app.TruelyServer) and server.detector is det
    assert server.config.port == 5999
    assert japp.create_app.__name__ == app.create_app.__name__


@pytest.mark.parametrize("batch,size", [(3, 80), (2, 40)])
def test_synthetic_landmark_batch_equals_jax(batch, size):
    got = synthetic_landmark_batch(np.random.default_rng(7), batch, size)
    want = j_synthetic(np.random.default_rng(7), batch, size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
