"""The port's ``save_params``: the flat ``.npz`` it writes is the JAX
package's layout (``truely_tpu.models.weights.load_params`` reads the same
tree structure as the JAX init), and the port reads it back into equal
modules."""

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


@pytest.mark.parametrize("name", list(INITS))
def test_save_params_round_trips_through_both_readers(tmp_path, name):
    module = tweights.init_params(name, seed=3)
    path = str(tmp_path / f"{name}.npz")
    tweights.save_params(path, module)
    tree = jweights.load_params(path)
    with np.load(path) as z:
        assert len(z.files) == len(module.state_dict())
    back, loaded = tweights.load_or_init(name, str(tmp_path))
    assert loaded
    for (key, a), (_, b) in zip(module.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), key
    init, loaded = jweights.load_or_init(name, INITS[name], weights_dir=str(tmp_path / "none"))
    assert not loaded
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(init)
    assert shapes(tree) == shapes(init)
    assert jweights.load_or_init(name, INITS[name], weights_dir=str(tmp_path))[1]
