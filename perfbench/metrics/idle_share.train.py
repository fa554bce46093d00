"""The device's idle share of the traced window, in %."""
from perfbench.readers import idle_share as read  # noqa: F401
