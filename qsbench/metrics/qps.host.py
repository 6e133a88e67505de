"""qps.host: qps (qsbench/metrics/qps.py) read in the traced run of a cell
whose end-to-end metric is the card's time: the whole path on the host
clock, each layer's host work with it."""

from qsbench import registry

read = registry.reader("qps")
