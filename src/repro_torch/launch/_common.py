"""Shared launcher flag surface.

Every launcher that touches a model takes ``--arch/--reduced``; every one
that can deploy across hosts takes ``--hosts/--transport``.  Defining them
here keeps the CLIs mirror images of each other, and of the JAX package's
launchers, whose flags they take.

The flags of parts the port has not brought yet parse as they do in the
JAX package and then refuse, naming what brings them
(:func:`refuse_later_flags`): ``--autoscale`` / ``--min-hosts`` /
``--max-hosts`` come with the autoscaler, and ``--virtual-devices`` fakes
XLA host devices, which a PyTorch process has none of.
"""

from __future__ import annotations

import argparse
import os
import sys

TRANSPORTS = ["inprocess", "pipe", "shm", "device"]

# well-known tcmalloc locations (debian/ubuntu images); preloading it in
# the environment makes every SPAWNED host inherit the faster allocator
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)

AUTOSCALE_SLICE = ("the autoscaler (cluster/autoscale.py) comes with a later "
                   "slice of the port")


def add_model_flags(ap: argparse.ArgumentParser, *,
                    required: bool = True) -> argparse.ArgumentParser:
    ap.add_argument("--arch", required=required,
                    help="model architecture name (see repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true",
                    help="CI-sized config: same wiring, tiny dims")
    return ap


def add_cluster_flags(ap: argparse.ArgumentParser, *,
                      default_hosts: int = 2,
                      default_transport: str = "pipe") -> argparse.ArgumentParser:
    ap.add_argument("--hosts", type=int, default=default_hosts,
                    help="simulated host count"
                         + (" (0 = stay in-process, no deployment)"
                            if default_hosts == 0 else ""))
    ap.add_argument("--transport", default=default_transport,
                    choices=TRANSPORTS,
                    help="cut-channel transport between hosts ('device': "
                         "thread hosts whose tensors stay on the card)")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="an XLA flag of the JAX package's launcher; "
                         "refused here (multi-device comes last, ROADMAP "
                         "§1 item 12)")
    ap.add_argument("--tcmalloc", action="store_true",
                    help="LD_PRELOAD tcmalloc (when present on the image) "
                         "so every spawned host inherits the faster "
                         "allocator; off by default — a global allocator "
                         "swap should be an explicit choice")
    ap.add_argument("--autoscale", action="store_true",
                    help="resize the plan between batches when load "
                         "demands it; refused until the autoscaler is "
                         "ported")
    ap.add_argument("--min-hosts", type=int, default=None, metavar="N",
                    help="autoscale floor (refused with --autoscale)")
    ap.add_argument("--max-hosts", type=int, default=None, metavar="N",
                    help="autoscale ceiling (refused with --autoscale)")
    return ap


def refuse_later_flags(args) -> None:
    """``SystemExit`` naming the part of the port that brings a flag the
    port cannot honour yet."""
    if getattr(args, "virtual_devices", 0):
        raise SystemExit(
            "--virtual-devices fakes XLA host devices for the JAX package; "
            "the port's multi-device path comes last (ROADMAP §1 item 12)")
    if (getattr(args, "autoscale", False)
            or getattr(args, "min_hosts", None) is not None
            or getattr(args, "max_hosts", None) is not None):
        raise SystemExit(f"--autoscale / --min-hosts / --max-hosts: "
                         f"{AUTOSCALE_SLICE}")


def apply_runtime_env(args) -> None:
    """Process-environment set-up a launcher applies right after
    ``parse_args``, before it spawns a host: refuse what the port cannot
    honour yet, and (opt-in via ``--tcmalloc``, when present on the image)
    preload tcmalloc for the spawned hosts."""
    refuse_later_flags(args)
    if getattr(args, "tcmalloc", False) and "LD_PRELOAD" not in os.environ:
        for lib in _TCMALLOC_CANDIDATES:
            if os.path.exists(lib):
                # too late for THIS process (the loader already ran) but
                # every spawned host interpreter inherits the allocator
                os.environ["LD_PRELOAD"] = lib
                print(f"[launch] LD_PRELOAD={lib} for spawned hosts "
                      "(--tcmalloc)", file=sys.stderr)
                break
