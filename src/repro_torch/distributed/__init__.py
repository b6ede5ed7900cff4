"""The port's multi-device layer (``repro/distributed``): sharding rules and
DTensor placements, and the train / prefill / decode steps on one device
or over a ``(data, model)`` device mesh (data parallelism with FSDP
storage; see ``steps.py``)."""
from .sharding import (  # noqa: F401
    P,
    ShardingRules,
    batch_pspecs,
    cache_pspecs,
    default_rules,
    param_pspecs,
    to_placements,
)
from .steps import (  # noqa: F401
    ShardedState,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    shard_state,
)
