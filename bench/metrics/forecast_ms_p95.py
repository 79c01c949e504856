"""95th percentile of every request's latency in the window, from
dispatching its gather to its forecasts on the host, in ms."""
import statistics


def read(rec):
    if rec.mode != "forecast" or len(rec.latencies_s) < 2:
        return None
    return statistics.quantiles(rec.latencies_s, n=20, method="inclusive")[-1] * 1e3
