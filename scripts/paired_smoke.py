"""chip_smoke.py from several checkouts in turn on one card, every line of
each run stamped with the seconds since its start, then the seconds each
phase took in each run (the time from one line to the next, summed by the
line's ``[tag]``).

    python3 scripts/paired_smoke.py OUT CHECKOUT [CHECKOUT ...] [-- ARGS]
    python3 scripts/paired_smoke.py --sum LOG [LOG ...]

The first form writes OUT_<i>_<checkout name>.log for each run (pass ARGS
on to chip_smoke.py, e.g. ``-- --only=13``) and prints its exit code and
wall seconds; a parent and a change compare best in the order parent,
change, change, parent.  ``--sum`` prints the table for logs already
written.  Make the checkouts with ``git archive`` (e.g. of HEAD and of
``git write-tree``) into a directory that .gitignore lists.
"""

import os
import re
import subprocess
import sys
import time


def run(out, checkout, i, args):
    log = f"{out}_{i}_{os.path.basename(os.path.normpath(checkout))}.log"
    t0 = time.time()
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, "-u", "chip_smoke.py", *args], cwd=checkout,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in p.stdout:
            f.write(f"{time.time() - t0:9.2f} {line}")
            f.flush()
        rc = p.wait()
    print(f"{log}: rc {rc} in {time.time() - t0:.1f} s", flush=True)
    return log


def phases(log):
    """{tag: seconds} in the order of first appearance, and the last stamp."""
    out, prev = {}, 0.0
    for line in open(log):
        m = re.match(r"\s*([\d.]+) (\[[^\]]+\])?", line)
        if not m:
            continue
        t = float(m.group(1))
        tag = m.group(2) or "(other)"
        out[tag] = out.get(tag, 0.0) + t - prev
        prev = t
    return out, prev


def table(logs):
    runs = [phases(log) for log in logs]
    tags = list(dict.fromkeys(t for r, _ in runs for t in r))
    print("phase".ljust(14) + "".join(os.path.basename(log)[:18].rjust(20) for log in logs))
    for tag in tags:
        print(tag.ljust(14) + "".join(f"{r.get(tag, 0.0):20.1f}" for r, _ in runs))
    print("last line".ljust(14) + "".join(f"{end:20.1f}" for _, end in runs))


def main():
    argv = sys.argv[1:]
    if argv[0] == "--sum":
        table(argv[1:])
        return
    args = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    out, checkouts = argv[0], argv[1:]
    table([run(out, c, i, args) for i, c in enumerate(checkouts, 1)])


if __name__ == "__main__":
    main()
