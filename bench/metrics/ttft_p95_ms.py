"""ttft_p95_ms: the 95th percentile (nearest rank) over every request of
the window of its time to first token, on the harness's clock.  In the
closed loop a batch is submitted when the serving entry is called, and its
first tokens are made when the prefill has returned and the device is
synchronised; every request of the batch waits that long."""

import math


def read(rec):
    ttft = sorted((b.t_first - b.t_submit) * 1e3
                  for b in rec.timed() for _ in range(b.tokens.shape[0]))
    return ttft[math.ceil(0.95 * len(ttft)) - 1] if ttft else None
