"""Host engine: the 95th percentile over the window's messages of the time
from the push that delivered a message's last sample to the return of the
push or flush that returned it (harness clock)."""

import numpy as np


def read(ctx):
    lat = ctx["latency_s"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
