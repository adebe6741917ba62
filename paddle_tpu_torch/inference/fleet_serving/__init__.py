"""Fleet serving (counterpart of paddle_tpu/inference/fleet_serving):
so far the SLA admission scheduler."""
from .scheduler import Priority, SLAPolicy, SLAScheduler  # noqa: F401
