"""Store tooling: ``python -m repro_torch.persist --inspect|--verify <dir>``.

``--inspect`` prints the manifest schema version, categories with their
fingerprints and sizes, and staleness of each category against a live
engine rebuilt from the store's own dataset (a hardware/code change
shows up here as a stale planner/kernel category before any restore is
attempted).

``--verify`` round-trips the store: builds a cold engine from the stored
dataset + config, a warm engine through ``warm_store=<dir>``, replays
the stored scene-cache queries on both, and diffs masks/counts.  Exit
code 0 only on bit-identity.

Both build engines, so both take ``--device`` with the port's policy: the
card by default (raising without one), ``--device cpu`` for the plain
PyTorch versions on the host.  ``--verify`` also prints the warm engine's
construction seconds and the seconds from its construction to its first
answer.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _cat_bytes(entry: dict) -> int:
    return sum(
        int(np.prod(a["shape"])) * np.dtype(a["dtype"]).itemsize
        for a in entry.get("arrays", {}).values()
    )


def _engine_from_store(
    manifest: dict, folder: str, warm_store: str | None = None, device=None
):
    from repro_torch.checkpoint.store import load_arrays
    from repro_torch.core.engine import RkNNConfig, RkNNEngine
    from repro_torch.core.geometry import Rect

    extra = manifest.get("extra", {}).get("engine", {})
    dcat = manifest["categories"]["dataset"]
    data = load_arrays(folder, dcat)
    cfg = dict(extra.get("config", {}))
    cfg.pop("warm_store", None)
    cfg["warm_store"] = warm_store
    # flight/obs side-effects are irrelevant to a verification build
    cfg["flight_recorder"] = False
    kwargs = {"device": device}
    if dcat.get("meta", {}).get("explicit_rect"):
        kwargs["rect"] = Rect(*(float(v) for v in dcat["meta"]["rect"]))
    cls_name = extra.get("class", "RkNNEngine")
    if cls_name == "ShardedEngine":
        from repro_torch.shard.engine import ShardedEngine

        return ShardedEngine(
            data["facilities"],
            data["users"],
            RkNNConfig(**cfg),
            shards=int(extra.get("n_shards", 1)),
            **kwargs,
        )
    if cls_name == "DynamicEngine":
        from repro_torch.dynamic.engine import DynamicEngine

        return DynamicEngine(
            data["facilities"], data["users"], RkNNConfig(**cfg), **kwargs
        )
    return RkNNEngine(data["facilities"], data["users"], RkNNConfig(**cfg), **kwargs)


def _stored_queries(manifest: dict) -> list[tuple[object, int]]:
    """The (q, k) pairs the store's scene cache actually holds — the
    exact working set a warm restore claims to make free."""
    ents = manifest.get("categories", {}).get("scenes", {}).get("meta", {})
    out = []
    for ent in ents.get("entries", []):
        qk = ent["q_key"]
        q = int(qk) if isinstance(qk, int) else np.asarray(qk, np.float64)
        out.append((q, int(ent["k"])))
    return out


def inspect(directory: str, step: int | None, device=None) -> int:
    from repro_torch.checkpoint.store import load_state
    from repro_torch.persist.store import expected_fingerprints

    try:
        manifest, folder = load_state(directory, step)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"store:  {directory}")
    print(f"schema: {manifest.get('schema')}")
    print(f"step:   {manifest.get('step')}")
    extra = manifest.get("extra", {}).get("engine", {})
    if extra:
        print(
            f"engine: {extra.get('class')} backend="
            f"{extra.get('config', {}).get('backend')} "
            f"shards={extra.get('n_shards', 1)}"
        )
    live = {}
    try:
        eng = _engine_from_store(manifest, folder, device=device)
        live = expected_fingerprints(eng, eng._snap)
    except Exception as e:
        print(f"(live fingerprint check unavailable: {type(e).__name__}: {e})")
    print(f"{'category':<10} {'fingerprint':<18} {'arrays':>6} {'size':>10}  staleness")
    for name, entry in manifest.get("categories", {}).items():
        fp = entry.get("fingerprint", "")
        if not live:
            state = "?"
        elif live.get(name) == fp:
            state = "fresh"
        elif name in live:
            state = f"STALE (live {live[name]})"
        else:
            state = "unknown category"
        print(
            f"{name:<10} {fp:<18} {len(entry.get('arrays', {})):>6} "
            f"{_fmt_bytes(_cat_bytes(entry)):>10}  {state}"
        )
    return 0


def verify(directory: str, step: int | None, device=None) -> int:
    from repro_torch.checkpoint.store import load_state

    try:
        manifest, folder = load_state(directory, step)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    queries = _stored_queries(manifest)
    if not queries:
        n = int(
            manifest["categories"]["dataset"]["meta"].get("n_facilities", 0)
        )
        queries = [(q, 8) for q in range(min(4, n))]
    print(f"verify: replaying {len(queries)} stored queries cold vs warm")
    cold = _engine_from_store(manifest, folder, device=device)
    t0 = time.perf_counter()
    warm = _engine_from_store(manifest, folder, warm_store=directory, device=device)
    t_warm = time.perf_counter() - t0
    restored = {
        name: st.get("status")
        for name, st in warm.persist_info.get("categories", {}).items()
    }
    print(f"warm restore: {restored}")
    bad = 0
    for i, (q, k) in enumerate(queries):
        rw = warm.query(q, k)
        if i == 0:
            print(f"warm engine: constructed in {t_warm:.3f}s, first answer "
                  f"{time.perf_counter() - t0:.3f}s after construction began")
        rc = cold.query(q, k)
        ok = bool(
            np.array_equal(np.asarray(rc.mask), np.asarray(rw.mask))
            and np.array_equal(np.asarray(rc.counts), np.asarray(rw.counts))
        )
        if not ok:
            bad += 1
            d = int(np.sum(np.asarray(rc.mask) != np.asarray(rw.mask)))
            print(f"  MISMATCH q={q} k={k}: {d} mask rows differ")
    if bad:
        print(f"FAIL: {bad}/{len(queries)} queries diverge from cold build")
        return 1
    print(f"OK: {len(queries)} queries bit-identical (masks and counts)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.persist", description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--inspect", metavar="DIR", help="print manifest + staleness")
    g.add_argument("--verify", metavar="DIR", help="round-trip and diff vs cold build")
    ap.add_argument("--step", type=int, default=None, help="store step (default newest)")
    ap.add_argument("--json", action="store_true", help="inspect: dump raw manifest JSON")
    ap.add_argument(
        "--device", default=None,
        help="device of the engines (default: the card; 'cpu' for the plain versions)",
    )
    args = ap.parse_args(argv)
    if args.inspect:
        if args.json:
            from repro_torch.checkpoint.store import load_state

            manifest, _ = load_state(args.inspect, args.step)
            json.dump(manifest, sys.stdout, indent=2, default=str)
            print()
            return 0
        return inspect(args.inspect, args.step, args.device)
    return verify(args.verify, args.step, args.device)


if __name__ == "__main__":
    sys.exit(main())
