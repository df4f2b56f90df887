"""The forward's share of a scan: the program's "device busy" seconds
(forward spans, CUDA events) over its SERVED seconds, summed over the
window's scans."""


def read(record):
    scans = [s for s in record.get("scans", []) if "busy_s" in s and s.get("served_s")]
    if not scans:
        return None
    return 100.0 * sum(s["busy_s"] for s in scans) / sum(s["served_s"] for s in scans)
