"""``python -m repro_torch.obs`` — inspect recordings, snapshots, postmortems.

    python -m repro_torch.obs trace.json               # per-span latency digest
    python -m repro_torch.obs trace.json --slowest 10  # widest spans
    python -m repro_torch.obs --prom metrics.json      # snapshot → Prometheus text
    python -m repro_torch.obs --postmortem flight/<bundle>.json  # flight digest

It reads JSON files only: it touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys

from .export import _from_chrome, summarize
from .promtext import render_snapshot


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:8.3f}s "
    if v >= 1e-3:
        return f"{v * 1e3:8.3f}ms"
    return f"{v * 1e6:8.1f}µs"


def _digest_trace(path: str, slowest: int) -> int:
    with open(path) as fh:
        obj = json.load(fh)
    recs = _from_chrome(obj)
    dropped = obj.get("otherData", {}).get("dropped_spans", 0)
    print(f"{len(recs)} spans ({dropped} dropped at record time)")
    print(f"{'span':<28}{'count':>7}{'total':>11}{'p50':>11}{'p99':>11}")
    for label, s in summarize(recs).items():
        print(
            f"{label:<28}{s['count']:>7}"
            f"{_fmt_s(s['sum']):>11}{_fmt_s(s['p50']):>11}{_fmt_s(s['p99']):>11}"
        )
    if slowest:
        recs.sort(key=lambda r: r["t0"] - r["t1"])
        print(f"\nslowest {slowest}:")
        for r in recs[:slowest]:
            attrs = ",".join(f"{k}={v}" for k, v in sorted(r["attrs"].items()))
            print(f"  {_fmt_s(r['t1'] - r['t0'])}  {r['name']}  {attrs}")
    return 0


def _render_prom(path: str) -> int:
    """A metrics snapshot (flat dict, or any JSON object with a
    ``metrics`` section — e.g. a flight bundle) as Prometheus text."""
    with open(path) as fh:
        obj = json.load(fh)
    snap = obj.get("metrics", obj) if isinstance(obj, dict) else obj
    sys.stdout.write(render_snapshot(snap))
    return 0


def _digest_postmortem(path: str, slowest: int) -> int:
    """Human-readable flight-bundle digest: what / when / why, the
    breached sentinel rules, and the slowest recorded spans."""
    with open(path) as fh:
        b = json.load(fh)
    schema = b.get("schema", "?")
    eng = b.get("engine") or {}
    planner = b.get("planner") or {}
    print(f"flight bundle {schema} — reason: {b.get('reason')}")
    print(f"  at      {b.get('wall_time')}")
    print(
        f"  engine  {eng.get('class')} v{eng.get('version')} "
        f"fp={eng.get('fingerprint')} "
        f"F={eng.get('n_facilities')} U={eng.get('n_users')}"
    )
    shards = eng.get("shards")
    if shards:
        print(
            f"  shards  {shards.get('n_shards')} shards, "
            f"{shards.get('n_users')} users, "
            f"imbalance {shards.get('imbalance'):.3f}"
        )
    if planner:
        print(
            f"  planner profile={planner.get('profile')} "
            f"epoch={planner.get('epoch')}"
        )
    exc = b.get("exception")
    if exc:
        print(f"  exception {exc.get('type')}: {exc.get('message')}")
        tb = exc.get("traceback") or []
        if tb:
            print("    " + tb[-1].strip().replace("\n", "\n    "))
    sent = b.get("sentinel")
    if sent:
        tripped = {k: v for k, v in sent.items() if v.get("tripped")}
        if tripped:
            print(f"  breached rules ({len(tripped)}):")
            for name, st in sorted(tripped.items()):
                print(
                    f"    {name}: last={st.get('last')} "
                    f"baseline={st.get('baseline')} ({st.get('last_breach')})"
                )
        else:
            print("  sentinel: no rules tripped")
    recs = b.get("spans") or []
    print(
        f"  {len(recs)} spans captured "
        f"({b.get('spans_dropped', 0)} dropped, "
        f"{b.get('intern_overflows', 0)} intern overflows)"
    )
    n = slowest or 5
    widest = sorted(recs, key=lambda r: r["t0"] - r["t1"])[:n]
    if widest:
        print(f"  slowest {len(widest)}:")
        for r in widest:
            attrs = ",".join(f"{k}={v}" for k, v in sorted(r["attrs"].items()))
            print(f"    {_fmt_s(r['t1'] - r['t0'])}  {r['name']}  {attrs}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize a Chrome-trace recording, render a metrics "
        "snapshot as Prometheus text, or digest a flight bundle",
    )
    ap.add_argument(
        "trace", nargs="?", default=None,
        help="trace JSON written by write_chrome_trace()",
    )
    ap.add_argument(
        "--slowest", type=int, default=0, metavar="N",
        help="also list the N widest spans",
    )
    ap.add_argument(
        "--prom", default=None, metavar="SNAPSHOT",
        help="render a metrics-snapshot JSON (or a flight bundle's metrics "
        "section) as Prometheus text and exit",
    )
    ap.add_argument(
        "--postmortem", default=None, metavar="BUNDLE",
        help="print a human-readable digest of a flight-recorder bundle",
    )
    args = ap.parse_args(argv)

    if args.prom:
        return _render_prom(args.prom)
    if args.postmortem:
        return _digest_postmortem(args.postmortem, args.slowest)
    if args.trace is None:
        ap.error("a trace file, --prom, or --postmortem is required")
    return _digest_trace(args.trace, args.slowest)


if __name__ == "__main__":
    sys.exit(main())
