"""Results archiver (a copy of the JAX package's ``utils/results_archive.py``,
stdlib only): pack a run's artifacts (logs, config, learned-hparam CSVs;
the checkpoints only when asked) into one tar.gz that any transport can
ship, and list or delete the archives of a directory. The reference ships
a Google-Drive uploader for the same purpose.
"""

import os
import tarfile
import time
from typing import List, Optional

#: artifact names worth shipping (checkpoints excluded by default — they are
#: the bulk of a run dir and rarely wanted off-device)
_DEFAULT_INCLUDE = ("logs", "config.yaml", "lrs.csv", "betas.csv", "visual_outputs")


def pack_run(
    run_dir: str,
    archive_dir: str,
    include_checkpoints: bool = False,
    archive_name: Optional[str] = None,
) -> str:
    """Tar a run directory's artifacts into ``archive_dir``; returns the path."""
    run_dir = run_dir.rstrip("/")
    if not os.path.isdir(run_dir):
        raise FileNotFoundError(run_dir)
    os.makedirs(archive_dir, exist_ok=True)
    stem = archive_name or os.path.basename(run_dir)
    base = os.path.join(archive_dir, f"{stem}.{time.strftime('%Y%m%d-%H%M%S')}")
    out_path, n = base + ".tar.gz", 0
    while os.path.exists(out_path):  # same stem in the same second
        n += 1
        out_path = f"{base}.{n}.tar.gz"
    include = _DEFAULT_INCLUDE + (("saved_models",) if include_checkpoints else ())
    with tarfile.open(out_path, "w:gz") as tar:
        for name in include:
            path = os.path.join(run_dir, name)
            if os.path.exists(path):
                tar.add(path, arcname=os.path.join(os.path.basename(run_dir), name))
    return out_path


def list_archives(archive_dir: str) -> List[str]:
    if not os.path.isdir(archive_dir):
        return []
    return sorted(
        os.path.join(archive_dir, f) for f in os.listdir(archive_dir) if f.endswith(".tar.gz")
    )


def delete_archive(path: str) -> None:
    """Remove one archive (the uploader's ``delete_file`` management op)."""
    if not path.endswith(".tar.gz"):
        raise ValueError(f"refusing to delete non-archive path {path!r}")
    os.remove(path)
