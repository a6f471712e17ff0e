"""Device-mesh parallelism: DP/SP over frames, TP over the embedder, PP
over the block chain, training (counterpart of ``truely_tpu/parallel``)."""

from truely_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from truely_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, pipeline_block17, shard_stage_params, stack_block_params,
)
from truely_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_frame_step, replicate, dp_spec, tp_shard_facenet,
)
from truely_tpu_torch.parallel.train import make_train_step, TrainState  # noqa: F401
