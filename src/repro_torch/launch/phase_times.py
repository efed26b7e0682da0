"""Seconds each phase of a ``chip_smoke.py`` run took.

  python3 src/repro_torch/launch/phase_times.py [--label L] [--cwd DIR] \
      -- python3 chip_smoke.py [arguments]

Runs the command (in ``--cwd``, default the current directory), passes
its standard output through, and stamps each line with its arrival time
in seconds since the start. ``chip_smoke.py`` prints one JSON line a
phase when the phase is done, so a phase's seconds are the time from the
line before it to its own. Writes every stamped line and a summary (the
seconds by phase, summed over a phase's repeated lines, and the whole
run's) to ``chiprun_out/phase_times_<label>.json`` beside this repo's
root and prints the summary as its last line. ``--cwd`` names another
tree (one unpacked by ``git archive``, say), so two trees are timed on
one card in one go. Exits with the command's code.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        print("phase_times: give the command after --", file=sys.stderr)
        return 2
    cut = argv.index("--")
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="run")
    ap.add_argument("--cwd", default=".")
    args = ap.parse_args(argv[:cut])
    cmd = argv[cut + 1:]
    t0 = time.time()
    last, lines, by_phase = 0.0, [], {}
    proc = subprocess.Popen(cmd, cwd=args.cwd, stdout=subprocess.PIPE,
                            text=True, bufsize=1)
    for line in proc.stdout:
        sys.stdout.write(line)
        now = time.time() - t0
        lines.append([round(now, 2), line.rstrip("\n")[:300]])
        try:
            phase = json.loads(line).get("phase")
        except (ValueError, AttributeError):
            phase = None
        if phase:
            by_phase[phase] = round(by_phase.get(phase, 0.0) + now - last, 2)
            last = now
    rc = proc.wait()
    summary = dict(label=args.label, command=cmd, rc=rc,
                   seconds=round(time.time() - t0, 2), by_phase=by_phase)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"phase_times_{args.label}.json").write_text(
        json.dumps(dict(summary, lines=lines), indent=1))
    print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main())
