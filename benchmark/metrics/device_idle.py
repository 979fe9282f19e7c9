"""`device_idle.<cells>`: the share of the traced window, in %, in which
no operation ran on the device."""

from benchmark.devtrace import idle_percent as read  # noqa: F401
