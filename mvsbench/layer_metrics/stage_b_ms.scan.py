"""Stage B's ms a scan: the program's SERVED seconds minus the sum of its
stage A phases (the filter, the fusion and the PLY), the mean over the
window's scans."""

import statistics


def read(record):
    scans = [s for s in record.get("scans", []) if "phases_s" in s and "served_s" in s]
    if not scans:
        return None
    return statistics.fmean(1e3 * (s["served_s"] - sum(s["phases_s"].values())) for s in scans)
