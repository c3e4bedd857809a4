"""Shared launcher flag surface.

Every launcher that touches a model takes ``--arch/--reduced``; every one
that can deploy across hosts takes ``--hosts/--transport``.  Defining them
here keeps the CLIs mirror images of each other, and of the JAX package's
launchers, whose flags they take.

``--autoscale`` / ``--min-hosts`` / ``--max-hosts`` describe an
:class:`~repro_torch.cluster.AutoscalePolicy` (:func:`autoscale_policy`).
``--virtual-devices N`` (the JAX package fakes N XLA host devices) runs
the training launcher as a world of N local ranks
(:func:`repro_torch.launch.mesh.run_world`).  In the cluster and serve
launchers it gives the ``device`` transport N virtual devices to place its
hosts on (:func:`transport_of`), as the JAX package's ``jaxmesh``
transport places host *h* on device ``h % N``.
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
                    help="place the device transport's hosts on N virtual "
                         "devices: host h on virtual device h %% N, which "
                         "is cuda:((h %% N) %% card count) on the card and "
                         "--device off it. Other transports take the flag "
                         "and are unchanged by it: in the JAX package it "
                         "is also an XLA environment variable (the device "
                         "count its sharded stages see), which has no "
                         "counterpart here")
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


def transport_of(args):
    """The ``transport=`` of a deployment: the ``--transport`` name, or
    for ``device`` with ``--virtual-devices N`` a transport that places
    its hosts on N virtual devices."""
    n = int(getattr(args, "virtual_devices", 0) or 0)
    if args.transport != "device" or not n:
        return args.transport
    from ..cluster.transport import make_transport
    return make_transport("device", virtual_devices=n)


def apply_runtime_env(args) -> None:
    """Process-environment set-up a launcher applies right after
    ``parse_args``, before it spawns a host: refuse a negative
    ``--virtual-devices``, and (opt-in via ``--tcmalloc``, when present on
    the image) preload tcmalloc for the spawned hosts."""
    if (getattr(args, "virtual_devices", 0) or 0) < 0:
        raise SystemExit(f"--virtual-devices: need N >= 0, got "
                         f"{args.virtual_devices}")
    if getattr(args, "tcmalloc", False) and "LD_PRELOAD" not in os.environ:
        for lib in _TCMALLOC_CANDIDATES:
            if os.path.exists(lib):
                # too late for THIS process (the loader already ran) but
                # every spawned host interpreter inherits the allocator
                os.environ["LD_PRELOAD"] = lib
                print(f"[launch] LD_PRELOAD={lib} for spawned hosts "
                      "(--tcmalloc)", file=sys.stderr)
                break
