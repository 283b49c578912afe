from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    ServeConfig,
    decode_step,
    prefill_step,
)
from repro_torch.serve.sim_engine import (  # noqa: F401
    SERVABLE_STEPPERS,
    Pod,
    ServerConfig,
    SimRequest,
    SimServer,
    fifo_event_tiles,
    packed_event_tiles,
)
