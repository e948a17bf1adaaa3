"""Volume detection: the mounted filesystems and their capacity.

Port of ``spacedrive_tpu/volume.py`` (upstream core/src/volume/mod.rs:101,
241): ``get_volumes`` reads ``/proc/mounts`` and calls ``statvfs`` on each
real mount point, leaving out pseudo filesystems; ``save_volumes`` upserts
them into the library's local ``volume`` table in one transaction.
"""

from __future__ import annotations

import os
from typing import Dict, List

_PSEUDO_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup", "cgroup2",
    "pstore", "securityfs", "debugfs", "tracefs", "overlay", "squashfs",
    "fusectl", "configfs", "mqueue", "hugetlbfs", "bpf", "autofs",
    "binfmt_misc", "rpc_pipefs", "nsfs", "efivarfs", "ramfs",
}


def get_volumes() -> List[Dict]:
    """Enumerate real mounted volumes with capacity info."""
    volumes = []
    seen_mounts = set()
    try:
        with open("/proc/mounts") as f:
            lines = f.readlines()
    except OSError:
        lines = []
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        device, mount_point, fstype = parts[0], parts[1], parts[2]
        if fstype in _PSEUDO_FS or mount_point in seen_mounts:
            continue
        mount_point = mount_point.encode().decode("unicode_escape")
        try:
            st = os.statvfs(mount_point)
        except OSError:
            continue
        total = st.f_blocks * st.f_frsize
        if total == 0:
            continue
        seen_mounts.add(mount_point)
        volumes.append({
            "name": os.path.basename(device) or device,
            "mount_point": mount_point,
            "filesystem": fstype,
            "total_bytes_capacity": str(total),
            "total_bytes_available": str(st.f_bavail * st.f_frsize),
            "is_system": mount_point == "/",
            "disk_type": None,
        })
    return volumes


def save_volumes(db) -> int:
    """Upsert detected volumes into the @local volume table — one tx
    for the whole detection sweep (tx-shape: no tx per volume)."""
    vols = get_volumes()
    with db.write_tx() as conn:
        for v in vols:
            db.upsert(
                "volume",
                {"mount_point": v["mount_point"], "name": v["name"]},
                {
                    "filesystem": v["filesystem"],
                    "total_bytes_capacity": v["total_bytes_capacity"],
                    "total_bytes_available": v["total_bytes_available"],
                    "is_system": int(v["is_system"]),
                }, conn=conn)
    return len(vols)
