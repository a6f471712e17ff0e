"""HTTP API server reproducing the reference's public endpoint surface
(counterpart of ``truely_tpu/serve``), on the port's detector."""

from truely_tpu_torch.serve.results import ResultStore  # noqa: F401
from truely_tpu_torch.serve.app import TruelyServer, create_app  # noqa: F401
