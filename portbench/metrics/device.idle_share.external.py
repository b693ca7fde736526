"""The device's idle share of the traced window in the spill cell, where it
moves ``external_qps``."""
from portbench.trace import idle_share as read  # noqa: F401
