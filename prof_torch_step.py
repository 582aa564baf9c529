"""Where the time of one RK3 step of the PyTorch port goes, on a CUDA card.

    python3 prof_torch_step.py [N ...]        (default: 128 256)

For each N it builds the flat-ABL case at N^3 float32 on the card, warms
up, times 10 steps with CUDA events, then traces 3 steps with
torch.profiler and prints the device-busy share of the traced wall time and
the kernels that take the most device time.  The full kernel table goes to
chiprun_out/prof_torch_step_<N>.txt.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

OUT = Path(__file__).resolve().parent / "chiprun_out"


def profile_case(n: int, smi: str) -> None:
    from udales_tpu_torch import entry
    model = entry._build(n, n, n, "float32", device="cuda")
    state = model.run(entry._init_state(model), 3)
    torch.cuda.synchronize()

    steps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = model.run(state, steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps

    traced = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = model.run(state, traced)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    per_kernel: dict = {}
    for e in events:
        tot, cnt = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    table = [f"{n}^3 float32 on {smi}: {ms:.4f} ms/step (CUDA events, "
             f"{steps} steps); traced {traced} steps: wall {wall_us:.1f} us, "
             f"device busy {busy_us:.1f} us = {busy_us / wall_us:.4f} of "
             f"wall, {len(events)} device activities "
             f"({len(events) / traced:.1f} per step)"]
    for name, (tot, cnt) in rows:
        table.append(f"{tot / traced:12.2f} us/step {cnt // traced:6d} "
                     f"calls/step  {tot / busy_us:7.4f}  {name[:110]}")
    OUT.mkdir(exist_ok=True)
    (OUT / f"prof_torch_step_{n}.txt").write_text("\n".join(table) + "\n")
    print("\n".join(table[:26]), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prof_torch_step: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for n in [int(a) for a in sys.argv[1:]] or [128, 256]:
        profile_case(n, smi)


if __name__ == "__main__":
    main()
