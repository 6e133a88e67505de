"""admit_wait_ms: the mean client latency of the queries completed in the
window less the mean of the PolicyEnforcer's own execution time of the
same statements (its ExecutionStats "query" entries): the time a query
waits to be admitted and dispatched, behind other sessions' statements."""


def read(run):
    lat = run.latencies_ms()
    if not lat or not run.enforcer_ms:
        return None
    return sum(lat) / len(lat) - sum(run.enforcer_ms) / len(run.enforcer_ms)
