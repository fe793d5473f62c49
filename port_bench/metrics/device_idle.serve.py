"""``device_idle.serve``: the share of the traced window in which the
device ran nothing."""

from port_bench.harness.readers import idle_share as read  # noqa: F401
