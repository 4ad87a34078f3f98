"""Multi-rank paths on ``torch.distributed``, and long-form features.

Counterpart of ``ssar_tpu/parallel/``: ``mesh`` (device meshes, the data-axis
helpers), ``synthesis_tp`` (channel-parallel synthesis), ``features_sp``
(long-form and sharded features), ``dryrun`` (the multichip dry run) and
``launch`` (gloo ranks on the CPU).
"""
from .mesh import data_sharding, get_mesh, make_mesh, replicate, shard_batch
from .synthesis_tp import shard_generator_params, synthesize_tp
