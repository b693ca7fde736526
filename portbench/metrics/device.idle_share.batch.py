"""The device's idle share of the traced window in the in-memory cells,
where it moves ``qps``."""
from portbench.trace import idle_share as read  # noqa: F401
