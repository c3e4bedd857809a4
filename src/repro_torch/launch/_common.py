"""Shared launcher flag surface.

Every launcher that touches a model takes ``--arch/--reduced``; every one
that can deploy across hosts takes ``--hosts/--transport``.  Defining them
here keeps the CLIs mirror images of each other, and of the JAX package's
launchers, whose flags they take.

``--autoscale`` / ``--min-hosts`` / ``--max-hosts`` describe an
:class:`~repro_torch.cluster.AutoscalePolicy` (:func:`autoscale_policy`).
``--virtual-devices N`` (the JAX package fakes N XLA host devices) runs
the training launcher as a world of N local ranks
(:func:`repro_torch.launch.mesh.run_world`).  The cluster and serve
launchers parse it and refuse it (:func:`refuse_later_flags`): their
``device`` transport places hosts on cards, not on the ranks of a mesh.
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
                         "refused here: hosts sit on cards, not on mesh "
                         "ranks (ROADMAP §1 item 12)")
    ap.add_argument("--tcmalloc", action="store_true",
                    help="LD_PRELOAD tcmalloc (when present on the image) "
                         "so every spawned host inherits the faster "
                         "allocator; off by default — a global allocator "
                         "swap should be an explicit choice")
    ap.add_argument("--autoscale", action="store_true",
                    help="poll the deployment's metrics between batches "
                         "and resize the plan when load demands it "
                         "(repro_torch.cluster.AutoscalePolicy defaults; "
                         "bound by --min-hosts/--max-hosts). Every action "
                         "is an epoch-bumped reconfigure with the "
                         "refinement re-proof, never a restart")
    ap.add_argument("--min-hosts", type=int, default=None, metavar="N",
                    help="autoscale floor (default: the starting --hosts)")
    ap.add_argument("--max-hosts", type=int, default=None, metavar="N",
                    help="autoscale ceiling (default: --hosts + 2)")
    return ap


def autoscale_policy(args):
    """The :class:`repro_torch.cluster.AutoscalePolicy` the flags describe,
    or ``None`` when ``--autoscale`` is off — pass straight to
    ``ClusterDeployment(autoscale=...)``."""
    if not getattr(args, "autoscale", False):
        return None
    from ..cluster import AutoscalePolicy
    hosts = int(getattr(args, "hosts", 1) or 1)
    lo = args.min_hosts if args.min_hosts is not None else hosts
    hi = args.max_hosts if args.max_hosts is not None else hosts + 2
    if not 1 <= lo <= hi:
        raise SystemExit(
            f"--min-hosts/--max-hosts: need 1 <= {lo} <= {hi}")
    return AutoscalePolicy(min_hosts=lo, max_hosts=hi)


def refuse_later_flags(args) -> None:
    """``SystemExit`` naming the part of the port that brings a flag the
    port cannot honour yet."""
    if getattr(args, "virtual_devices", 0):
        raise SystemExit(
            "--virtual-devices: this launcher's device transport places "
            "hosts on cards, not on the ranks of a mesh; only the training "
            "launcher runs a world of ranks (ROADMAP §1 item 12)")


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
