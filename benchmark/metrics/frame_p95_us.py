"""frame_p95_us: the 95th percentile over every frame of the window of the frame's
latency, from the command's upload to the estimates' arrival on the host, as the
card's clock reads it (a CUDA event recorded before the upload and one after the
estimates' copy, on the frame's stream)."""
import numpy as np


def read(run):
    lat = run.get('latency_ms')
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95)) * 1e3
