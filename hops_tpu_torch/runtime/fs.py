"""Project-scoped filesystem façade.

Re-creates the surface of the reference's ``hops.hdfs`` module
(reference: notebooks/ml/Filesystem/HopsFSOperations.ipynb, SURVEY.md
§2.2) on top of a pluggable storage backend. The reference's backend was
HopsFS/HDFS reached through native libhdfs; here the default backend is
POSIX (which covers local disk and FUSE-mounted GCS buckets), with the
backend interface kept narrow so a native C++ driver (e.g. a direct GCS
client) can slot in.

Paths behave like the reference's: relative paths are resolved against
the *project* root inside the workspace, mirroring
``hdfs.project_path()``; absolute paths are taken as-is.
"""

from __future__ import annotations

import getpass
import json
import os
import pickle
import shutil
import stat as stat_mod
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import config

_WORKSPACE_ENV = "HOPS_TPU_WORKSPACE"


def workspace_root() -> Path:
    """Root of all projects (the reference's HopsFS root)."""
    ws = config.runtime().workspace or os.environ.get(_WORKSPACE_ENV, "")
    if not ws:
        ws = str(Path.home() / "hops_tpu_workspace")
    p = Path(ws)
    p.mkdir(parents=True, exist_ok=True)
    return p


def project_name() -> str:
    """Reference: ``hdfs.project_name()``."""
    return config.runtime().project


def project_user() -> str:
    """Reference: ``hdfs.project_user()`` (``<project>__<user>``)."""
    return f"{project_name()}__{getpass.getuser()}"


def project_path(rel: str = "") -> str:
    """Absolute path of ``rel`` inside the current project's dataset root.

    Reference: ``hdfs.project_path()`` in
    notebooks/ml/Experiment/Tensorflow/mnist.ipynb:70.
    """
    root = workspace_root() / project_name()
    root.mkdir(parents=True, exist_ok=True)
    return str(root / rel) if rel else str(root) + os.sep


def resolve(path: str | Path) -> Path:
    """Absolute workspace path: relative inputs anchor at the project
    root, absolute inputs pass through."""
    p = Path(path)
    return p if p.is_absolute() else Path(project_path(str(p)))


_abs = resolve  # internal alias used throughout this module


# -- basic ops (reference: HopsFSOperations.ipynb cells 3-19) ----------------


def exists(path: str | Path) -> bool:
    return _abs(path).exists()


def mkdir(path: str | Path) -> None:
    _abs(path).mkdir(parents=True, exist_ok=True)


def rmr(path: str | Path) -> None:
    """Recursive remove (reference: ``hdfs.rmr``)."""
    p = _abs(path)
    if p.is_dir() and not p.is_symlink():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists():
        p.unlink()


def cp(src: str | Path, dst: str | Path, overwrite: bool = True) -> None:
    s, d = _abs(src), _abs(dst)
    if d.is_dir():
        d = d / s.name
    if d.exists() and not overwrite:
        raise FileExistsError(str(d))
    d.parent.mkdir(parents=True, exist_ok=True)
    if s.is_dir():
        shutil.copytree(s, d, dirs_exist_ok=True)
    else:
        shutil.copy2(s, d)


def move(src: str | Path, dst: str | Path) -> None:
    s, d = _abs(src), _abs(dst)
    d.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(s), str(d))


def rename(src: str | Path, dst: str | Path) -> None:
    move(src, dst)


def ls(path: str | Path = "", recursive: bool = False) -> list[str]:
    p = _abs(path)
    if recursive:
        return sorted(str(c) for c in p.rglob("*"))
    return sorted(str(c) for c in p.iterdir())


def glob(pattern: str) -> list[str]:
    """Glob within the project (reference: ``hdfs.glob``).

    Shell semantics: ``*`` does not cross ``/`` (use ``**`` to recurse).
    """
    return sorted(str(c) for c in Path(project_path()).glob(pattern))


def lsl(path: str | Path = "") -> list[dict[str, Any]]:
    """Detailed listing (reference: ``hdfs.lsl``)."""
    return [stat(c) for c in ls(path)]


def stat(path: str | Path) -> dict[str, Any]:
    st = _abs(path).stat()
    return {
        "path": str(_abs(path)),
        "size": st.st_size,
        "permission": stat_mod.filemode(st.st_mode),
        "owner": st.st_uid,
        "last_modified": st.st_mtime,
        "is_dir": _abs(path).is_dir(),
    }


def chmod(path: str | Path, mode: int) -> None:
    _abs(path).chmod(mode)


# -- data transfer (reference: copy_to_local / copy_to_hdfs) -----------------


def copy_to_local(path: str | Path, local_dir: str | Path = ".", overwrite: bool = True) -> str:
    """Stage a workspace file onto local disk (reference:
    ``hdfs.copy_to_local``, mnist.ipynb:77)."""
    src = _abs(path)
    dst = Path(local_dir) / src.name
    if dst.resolve() == src.resolve():
        return str(dst)
    if dst.exists() and not overwrite:
        raise FileExistsError(str(dst))
    if src.is_dir():
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst)
    return str(dst)


def copy_to_workspace(local_path: str | Path, rel_dir: str = "", overwrite: bool = True) -> str:
    """Upload a local file into the project (reference: ``hdfs.copy_to_hdfs``)."""
    src = Path(local_path)
    dst_dir = Path(project_path(rel_dir))
    dst_dir.mkdir(parents=True, exist_ok=True)
    dst = dst_dir / src.name
    if dst.exists() and not overwrite:
        raise FileExistsError(str(dst))
    if src.is_dir():
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy2(src, dst)
    return str(dst)


# `copy_to_hdfs` kept as an alias so reference-shaped code ports 1:1.
copy_to_hdfs = copy_to_workspace


# -- (de)serialization (reference: hdfs.load / hdfs.dump) --------------------


def dump(data: Any, path: str | Path) -> str:
    """Write text/bytes/obj to a project path (reference: ``hdfs.dump``)."""
    p = _abs(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, bytes):
        p.write_bytes(data)
    elif isinstance(data, str):
        p.write_text(data)
    else:
        p.write_bytes(pickle.dumps(data))
    return str(p)


def load(path: str | Path) -> bytes:
    """Read raw bytes (reference: ``hdfs.load``)."""
    return _abs(path).read_bytes()


def load_json(path: str | Path) -> Any:
    return json.loads(_abs(path).read_text())


def dump_json(data: Any, path: str | Path) -> str:
    p = _abs(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(data, indent=2, default=str))
    return str(p)
