"""roofline_share.tput: roofline_share (qsbench/metrics/roofline_share.py)
in a cell of several sessions, whose end-to-end metric is qps."""

from qsbench import registry

read = registry.reader("roofline_share")
