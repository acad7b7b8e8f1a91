"""Seconds each part of ``chip_smoke.py``'s edge phase takes, for one
checkout, in one process on the card (the flash edge checks, the gym and
codec kernels' edge checks, the semijoin trap check's child process):

    python3 tools/edge_phase_timing.py CHECKOUT [--child] [--serial-trap]

``CHECKOUT`` is a directory holding ``chip_smoke.py`` and ``src/`` (the
repo root, or an older commit unpacked with ``git archive``).  To compare
checkouts, run them interleaved in one call on one card (A, B, B, A).

- ``--child``: start the checkout's dry-run child process
  (``start_dryrun``, in the checkouts that had one) before the build, as
  their ``main`` did;
- ``--serial-trap``: wait for the trap check's child alone, after the other
  checks; without it a checkout whose ``chip_smoke.py`` has
  ``start_bitmap_trap`` starts that child before the other checks and
  collects it last, as its ``main`` does.  Checkouts without it always run
  the child alone (``bitmap_trap_check()``).

Prints one ``EDGE`` line: torch's import, the other imports, the build,
the edge phase's total and each part's seconds.
"""
import os
import subprocess
import sys
import time


def main() -> None:
    t_proc = time.perf_counter()
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    t0 = time.perf_counter()
    import torch

    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    import chip_smoke as CS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as K

    t_import = time.perf_counter() - t0
    child = CS.start_dryrun(torch) if "--child" in sys.argv else None
    t0 = time.perf_counter()
    build.compile_library()
    build.load()
    t_build = time.perf_counter() - t0
    dev = torch.device("cuda")

    def first_flash():
        q = torch.zeros((1, 1, 16, 64), dtype=torch.bfloat16, device="cuda")
        FA.flash_attention(q, q, q, causal=False)

    overlap = hasattr(CS, "start_bitmap_trap") and "--serial-trap" not in sys.argv
    serial = hasattr(CS, "start_bitmap_trap") and not overlap
    steps = [
        ("kernel_edge", lambda: CS.kernel_edge_checks(torch, K, ref, dev)),
        ("sorted", lambda: CS.sorted_probe_edge_checks(torch, K, ref, dev)),
        ("bitmap", lambda: CS.bitmap_edge_checks(torch, K, ref, dev)),
        ("wire", lambda: CS.wire_edge_checks(torch, dev)),
        ("flash_first_call", first_flash),
        ("flash", lambda: CS.flash_edge_checks(torch, dev)),
    ]
    parts = {}
    t_edge = time.perf_counter()
    trap = CS.start_bitmap_trap() if overlap else None
    if not overlap:
        steps.append(("trap", (lambda: CS.bitmap_trap_check(CS.start_bitmap_trap())) if serial
                      else CS.bitmap_trap_check))
    try:
        for name, fn in steps:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            parts[name] = round(time.perf_counter() - t, 3)
        if trap is not None:
            t = time.perf_counter()
            CS.bitmap_trap_check(trap)
            parts["trap_wait"] = round(time.perf_counter() - t, 3)
    finally:
        for proc in (trap, child):
            if isinstance(proc, subprocess.Popen) and proc.poll() is None:
                proc.kill()
    print(f"EDGE checkout={os.path.basename(tree)} flags={sys.argv[2:]} "
          f"torch_import={t_torch:.2f} imports={t_import:.2f} build={t_build:.2f} "
          f"edge_total={time.perf_counter() - t_edge:.2f} parts={parts} "
          f"process={time.perf_counter() - t_proc:.2f}", flush=True)


if __name__ == "__main__":
    main()
