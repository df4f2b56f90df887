"""Stage A's loader wait ms a view: the loader_wait phase of the program's
"stage A phases" line, summed over the window's scans, over their views."""


def read(record):
    scans = [s for s in record.get("scans", []) if "phases_s" in s and s.get("views")]
    if not scans:
        return None
    return 1e3 * sum(s["phases_s"].get("loader_wait", 0.0) for s in scans) / sum(s["views"] for s in scans)
