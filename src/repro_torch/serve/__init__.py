from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.sim_engine import (  # noqa: F401
    SERVABLE_STEPPERS,
    Pod,
    ServerConfig,
    SimRequest,
    SimServer,
    fifo_event_tiles,
    packed_event_tiles,
)
