"""serve.request_p95_ms: the 95th percentile of the requests' latency (due
to detections on the host) in a cell offered more than it serves, where
the queue grows through the run and the tail swings with it; host
clock."""

import statistics


def read(r):
    lat = r.record["latencies_s"]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[-1]
