"""The port's launcher environment hygiene against the JAX package's.

``tests/test_launch_env.py`` on ``repro_torch.launch._common``: the
tcmalloc preload is opt-in (``--tcmalloc``), announced on stderr, and never
clobbers an ``LD_PRELOAD`` the user already set.  Each case runs both
packages' helpers on the same arguments and requires the same outcome.
"""

import argparse
import os

import pytest

from repro.launch import _common as jcommon
from repro_torch.launch import _common as tcommon

PACKAGES = {"jax": jcommon, "port": tcommon}


def _args(**kw):
    ns = argparse.Namespace(virtual_devices=0, tcmalloc=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_cluster_flags_include_tcmalloc_off_by_default():
    for common in PACKAGES.values():
        ap = argparse.ArgumentParser()
        common.add_cluster_flags(ap)
        assert ap.parse_args([]).tcmalloc is False
        assert ap.parse_args(["--tcmalloc"]).tcmalloc is True


@pytest.fixture
def fake_tcmalloc(monkeypatch, tmp_path):
    lib = tmp_path / "libtcmalloc_minimal.so.4"
    lib.write_bytes(b"")
    for common in PACKAGES.values():
        monkeypatch.setattr(common, "_TCMALLOC_CANDIDATES", (str(lib),))
    return str(lib)


def test_tcmalloc_preload_is_opt_in_and_announced(monkeypatch, capsys,
                                                  fake_tcmalloc):
    for name, common in PACKAGES.items():
        monkeypatch.delenv("LD_PRELOAD", raising=False)
        common.apply_runtime_env(_args())  # default: allocator untouched
        assert "LD_PRELOAD" not in os.environ, name
        common.apply_runtime_env(_args(tcmalloc=True))  # opt-in + notice
        assert os.environ["LD_PRELOAD"] == fake_tcmalloc, name
        assert "--tcmalloc" in capsys.readouterr().err, name


def test_tcmalloc_never_clobbers_existing_preload(monkeypatch,
                                                  fake_tcmalloc):
    for name, common in PACKAGES.items():
        monkeypatch.setenv("LD_PRELOAD", "/custom/lib/mine.so")
        common.apply_runtime_env(_args(tcmalloc=True))
        assert os.environ["LD_PRELOAD"] == "/custom/lib/mine.so", name
