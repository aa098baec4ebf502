#!/usr/bin/env python
"""Driver benchmark: ONE JSON line for the headline metric.

Headline (BASELINE.json): audio-seconds/sec/chip on the decode -> 44.1k->16k
polyphase resample -> 128-bin log-mel graph; vs_baseline is the ratio to the
1000x-realtime target.

Runs on a GPU only; without one it fails instead of timing the CPU.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    from audioflow_tpu.bench import run_benchmark
    from audioflow_tpu.utils import setup_compile_cache

    setup_compile_cache()
    # streaming (chunked-scan) mode of the same graph at batch 512
    result = run_benchmark("logmel_stream", batch=512, seconds=10.0)
    value = result["realtime_factor_per_chip"]
    line = {
        "metric": "audio_seconds_per_sec_per_chip_logmel",
        "value": round(value, 2),
        "unit": "x realtime",
        "vs_baseline": round(value / 1000.0, 4),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
