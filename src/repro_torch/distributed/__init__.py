"""What runs across devices: the logical-axis sharding rules on a
``DeviceMesh`` (ZeRO-3 parameters and moments as DTensors), model-axis
tensor parallelism (Megatron's *f* and *g*, the vocab-parallel head and
embedding, decode over a sequence-split cache), int8 gradient compression
with error feedback, and the fault tolerance of a run (the straggler
watchdog, heartbeats, the elastic re-mesh plan)."""

from .compression import (compressed_psum_mean, compression_ratio, ef_init,
                          quantize_int8)
from .fault_tolerance import (HeartbeatRegistry, StragglerEvent,
                              StragglerWatchdog, elastic_plan)
from .sharding import (DECODE_RULES, DEFAULT_RULES, LONG_CONTEXT_RULES,
                       AxisRules, MeshSharding, axis_rules, constrain,
                       current_mesh, current_rules, placements_for,
                       shard_factor, sharding_for, spec_for)
from .tensor_parallel import (ModelAxis, copy_to_model, gather_from_model,
                              model_axis, model_slice, reduce_from_model,
                              scatter_to_model)

__all__ = ["AxisRules", "DECODE_RULES", "DEFAULT_RULES", "HeartbeatRegistry",
           "LONG_CONTEXT_RULES", "MeshSharding", "ModelAxis",
           "StragglerEvent",
           "StragglerWatchdog", "axis_rules", "compressed_psum_mean",
           "compression_ratio", "constrain", "copy_to_model", "current_mesh",
           "current_rules", "ef_init", "elastic_plan", "gather_from_model",
           "model_axis", "model_slice", "placements_for", "quantize_int8",
           "reduce_from_model", "scatter_to_model", "shard_factor",
           "sharding_for", "spec_for"]
