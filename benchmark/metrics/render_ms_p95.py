"""95th percentile of the window's request times (host call to the
synchronised spectrum), ms: the rank-based quantile of statistics.quantiles
(exclusive method) over every request."""

import statistics


def read(run):
    lat = run["window"].get("latencies_s")
    if run["kind"] != "render" or not lat:
        return None
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20)[18] * 1e3
