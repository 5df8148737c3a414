"""Persistent-process server: amortize device program compilation.

The production shape for the device engines is one resident process:
XLA programs compile once, and every subsequent analysis reuses them —
the numeric phase itself runs in seconds.  ``python -m genrich_tpu
--serve`` turns the CLI into that resident process:

  - reads one analysis per line from stdin: a full Genrich argument
    string (e.g. ``-t in.bam -o out.np --engine jax -r -q 0.05``);
  - runs it with a per---engine cached JaxEngine/ShardedEngine, so
    compiled programs persist across analyses;
  - prints one status line per analysis to stdout:
      ``OK <wall_seconds> [<perf_json>]``  or  ``ERR <wall_seconds>``
    (stderr carries the usual -v output and any error), and ``READY``
    at startup.  A failed analysis does not stop the server; clients
    that must not pass a failure treat ERR as one.

The OK line carries an optional third token — a JSON object with the
stage decomposition of the analysis (which ingest ran, the device
platform and count, ingest wall, upload bytes/time, dispatch and
blocking-fetch counts).  Clients must split the status line on the
FIRST two whitespace fields only (``line.split(None, 2)``), not into
exactly two tokens.

An empty line or ``EXIT`` ends the loop.  scripts/bench_e2e.py and
chip_smoke.py drive this to separate one-time compilation from
steady-state analysis wall time.

The reference has no equivalent (a fresh process per run,
Genrich.c:5697-5719); this is an extension.
"""

from __future__ import annotations

import json
import shlex
import sys
import time
from typing import List, Optional

from .errors import GenrichError
from .params import parse_args


def serve_loop(default_args: Optional[List[str]] = None,
               stdin=None, stdout=None) -> int:
    """Run analyses from stdin lines until EOF/EXIT; engines persist."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    default_args = default_args or []
    engines = {}

    def _engine(kind: str):
        eng = engines.get(kind)
        if eng is None:
            if kind == "jax":
                from .engine.jax_bridge import JaxEngine
                eng = JaxEngine()
            else:
                from .engine.sharded_bridge import ShardedEngine
                eng = ShardedEngine()
            engines[kind] = eng
        return eng

    from .pipeline import run

    print("READY", file=stdout, flush=True)
    for line in stdin:
        line = line.strip()
        if not line or line == "EXIT":
            break
        t0 = time.perf_counter()
        try:
            p = parse_args(default_args + shlex.split(line))
            eng = _engine(p.engine) if p.engine in ("jax", "sharded") \
                else None
            perf: dict = {}
            try:
                run(p, engine=eng, perf=perf)
            finally:
                if eng is not None:
                    eng.release()    # per-run state; programs persist
            # OK <wall> <json>: the stage decomposition of this
            # analysis — bench_e2e records it so warm serve time is a
            # measured split, not a guess
            msg = f"OK {time.perf_counter() - t0:.3f}"
            if perf:
                msg += " " + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in perf.items()}, sort_keys=True)
            print(msg, file=stdout, flush=True)
        except GenrichError as e:
            sys.stderr.write(e.render() + "\n")
            print(f"ERR {time.perf_counter() - t0:.3f}",
                  file=stdout, flush=True)
        except Exception:
            # an unexpected failure must not kill the server (a
            # client mid-protocol would hang until its timeout);
            # report and keep serving — engines were released above
            import traceback
            traceback.print_exc()
            print(f"ERR {time.perf_counter() - t0:.3f}",
                  file=stdout, flush=True)
    return 0
