"""Run ``chip_smoke.py``'s phases on one GPU with the kernels built from
other source trees, in turns: a parent's kernels against a change's, or a
deliberately broken copy against the checks that should catch it.

    PYTHONPATH=src python3 -m repro_torch.tools.compare_kernels \\
        --tree parent=build/parent/src/repro_torch/kernels/csrc \\
        --tree change=src/repro_torch/kernels/csrc \\
        --turns parent,change,change,parent \\
        --phases paged,decode,full_serve,fixed_serve,hybrid_fixed_serve

(or ``--phases gate,int8,eo_scene`` for the row kernels).

Run from the root of a checkout.  Each tree is a ``csrc/`` directory with
the same C interfaces as this one's.  The decode wrappers pass a null
workspace, so a tree whose decode kernels still write one (the earlier
split + merge design) cannot run under them.  Each turn is a child
process that builds the kernels from its tree (libraries are named by their sources'
hash, so trees share the build directory without colliding), then runs
``chip_smoke.phase_<name>`` for each named phase, in order: a phase
whose check fails is reported with its error and the turn goes on (the
tool exits 1 only if a child process itself fails).  The
children's JSON lines go to ``--out``; the last line printed is a
summary per turn and phase: the error if any, the first case's ``ms``
(the main shape in the kernel phases) and every case's, the decode
phases' rows beyond the main paths, ``prefill_s`` and
``decode_s_per_step``, the profiled prefill's and decode step's wall
and device-busy time (and the decode kernels' microseconds and
launches), the held-to-plain shares, and how many generated sequences
equal the first turn's; the kernel phases' launch floor, and eo_scene's
time per stage and tiles/s (its tiers come from ``phase_eo_figures``,
run first in that turn).  A child's first serve
phase prefills cold (the first matmuls set up cuBLAS), so its
``prefill_s`` is not the whole smoke's; the profiled prefill is warm in
both."""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

TURN_TIMEOUT_S = 900   # the phases above take ~2 min a turn on an H100


def _child(csrc: str, phases: list) -> int:
    import torch
    from repro_torch.kernels import build
    build.CSRC = Path(csrc).resolve()
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    given = {"ptxas": smoke.phase_build()}
    for name in phases:
        fn = getattr(smoke, f"phase_{name}")
        # a phase gets only the arguments it requires (full_serve's
        # optional cfg keeps its default, smollm-360m)
        args = [k for k, p in inspect.signature(fn).parameters.items()
                if p.default is inspect.Parameter.empty]
        if "cfg" in args and "cfg" not in given:
            from repro_torch.config import get_config
            from repro_torch.models import transformer as T
            given["cfg"] = get_config("zamba2-7b")
            given["params"] = T.init_params(given["cfg"], seed=0,
                                            device="cuda")
        if "tiers" in args and "tiers" not in given:
            # the EO phases' trained tiers and threshold, as main() has them
            run = smoke.phase_eo_figures()
            given.update(tiers=run["tiers"], thr=run["threshold"])
        t0 = time.perf_counter()
        try:
            fn(**{k: given[k] for k in args if k in given})
        except Exception as e:          # reported; the turn goes on
            smoke.emit("error", function=f"phase_{name}", error=repr(e))
        smoke.emit("phase_seconds", function=f"phase_{name}",
                   seconds=time.perf_counter() - t0)
    return 0


def _summary(turns: list, lines: list) -> dict:
    """Per turn, per phase line: the numbers a comparison reads."""
    out, first_tokens = [], {}
    for (name, _), got in zip(turns, lines):
        row = {}
        for ln in got:
            ph = ln.get("phase")
            if ph == "error":
                row.setdefault("errors", []).append(ln)
                continue
            keep = {}
            if (isinstance(ln.get("cases"), list) and ln["cases"]
                    and "ms" in ln["cases"][0]):
                c = ln["cases"][0]
                keep.update(shape=c.get("shape"), ms=c["ms"], cases_ms=[
                    [c.get("shape"), c.get("dtype"), c["ms"]]
                    for c in ln["cases"]])
            if ln.get("wide"):
                keep["wide_ms"] = [[c["name"], c["dtype"], c["ms"]]
                                   for c in ln["wide"]]
            for k in ("prefill_s", "decode_s_per_step", "held_to_plain",
                      "first_token_top2_gap", "launch_floor_ms", "stage_ms",
                      "tiles_per_s"):
                if k in ln:
                    keep[k] = ln[k]
            step = ln.get("decode_step")
            if step:
                prof = step.get("profiled_decode_step", {})
                keep["decode_step"] = dict(
                    held_to_plain=step["held_to_plain"],
                    **{k: prof[k] for k in ("wall_s", "device_busy_s",
                                            "device_busy_share",
                                            "decode_kernels_us",
                                            "decode_launches") if k in prof})
            if "profiled_prefill" in ln:
                keep.update({f"profiled_prefill_{k}": v for k, v in
                             ln["profiled_prefill"].items()
                             if k != "top_kernels_us"})
            if "tokens" in ln:
                ref = first_tokens.setdefault(ph, ln["tokens"])
                keep["same_tokens_as_first_turn"] = sum(
                    a == b for a, b in zip(ln["tokens"], ref))
                keep["first_divergence"] = [
                    next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None) for a, b in zip(ln["tokens"], ref)]
            if keep:
                row[ph] = keep
        out.append({"turn": name, **row})
    return {"summary": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=CSRC_DIR (repeatable)")
    ap.add_argument("--turns", required=True,
                    help="comma-separated tree names, run in this order")
    ap.add_argument("--phases", required=True,
                    help="comma-separated chip_smoke phase names")
    ap.add_argument("--out", default="build/compare_kernels.jsonl")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if args.child:
        return _child(args.child, phases)
    trees = dict(t.split("=", 1) for t in args.tree)
    turns = [(n, trees[n]) for n in args.turns.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines, failed = [], 0
    with out.open("w") as f:
        for name, csrc in turns:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.tools.compare_kernels",
                 "--child", csrc, "--turns", name, "--phases", args.phases],
                capture_output=True, text=True, timeout=TURN_TIMEOUT_S)
            got = []
            for ln in proc.stdout.splitlines():
                try:
                    got.append(json.loads(ln))
                except ValueError:
                    continue
            if proc.returncode:
                failed += 1
                got.append({"phase": "error", "returncode": proc.returncode,
                            "stderr": proc.stderr[-3000:]})
            for ln in got:
                f.write(json.dumps({"turn": name, "csrc": csrc, **ln}) + "\n")
            lines.append(got)
    print(json.dumps(_summary(turns, lines)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
