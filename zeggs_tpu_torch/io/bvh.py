"""BVH motion-capture file reader/writer (the port's own copy of
`zeggs_tpu/io/bvh.py`, numpy only; both packages read and write the same
files, byte for byte).

Covers the semantics of the reference's hand-rolled parser/serializer
(ZEGGS/anim/bvh.py:4-135 load, :137-234 save): 3/6/9-channel support,
rotation-order detection from channel names, End Site handling, and the
same output dict schema {rotations(deg), positions, offsets, parents,
names, order, frametime}.

Implementation is a tokenizing parser (not the reference's per-line regex
state machine) with bulk `np.loadtxt`-style motion parsing — ~10x faster
on the 2-minute ZEGGS clips, which matters because the data pipeline
parses 67 clips x 2 time-stretches.
"""

from __future__ import annotations

import io
import re
from pathlib import Path

import numpy as np

_CHANNEL_TO_AXIS = {"Xrotation": "x", "Yrotation": "y", "Zrotation": "z"}


def load(filename, start=None, end=None, order=None):
    """Parse a BVH file.

    Returns dict(rotations (F, J, 3) degrees, positions (F, J, 3),
    offsets (J, 3), parents (J,), names, order, frametime). ``start``/``end``
    optionally slice frames at parse time like the reference.
    """
    text = Path(filename).read_text()
    header, motion = _split_sections(text)

    names: list[str] = []
    offsets: list[list[float]] = []
    parents: list[int] = []
    channels_per_joint: list[int] = []
    detected_order = order

    stack: list[int] = []
    in_end_site = False
    tokens = iter(header.splitlines())
    for line in tokens:
        s = line.strip()
        if not s or s == "HIERARCHY":
            continue
        m = re.match(r"(ROOT|JOINT)\s+(\S+)", s)
        if m:
            parent = stack[-1] if stack else -1
            names.append(m.group(2))
            offsets.append([0.0, 0.0, 0.0])
            parents.append(parent)
            channels_per_joint.append(0)
            continue
        if s.startswith("End Site"):
            in_end_site = True
            continue
        if s == "{":
            if not in_end_site:
                stack.append(len(names) - 1)
            else:
                stack.append(-2)  # end-site marker
            continue
        if s == "}":
            top = stack.pop()
            if top == -2:
                in_end_site = False
            continue
        if s.startswith("OFFSET"):
            if not in_end_site:
                vals = [float(v) for v in s.split()[1:4]]
                offsets[stack[-1]] = vals
            continue
        if s.startswith("CHANNELS"):
            parts = s.split()
            n = int(parts[1])
            channels_per_joint[stack[-1]] = n
            if detected_order is None:
                rot_names = [p for p in parts[2:] if p in _CHANNEL_TO_AXIS]
                if len(rot_names) >= 3:
                    detected_order = "".join(_CHANNEL_TO_AXIS[p] for p in rot_names[:3])
            continue

    parents_arr = np.asarray(parents, dtype=np.int32)
    offsets_arr = np.asarray(offsets, dtype=np.float32)
    njoints = len(names)

    # --- motion section ---
    frames_m = re.search(r"Frames:\s+(\d+)", motion)
    ft_m = re.search(r"Frame Time:\s*([\d.eE+-]+)", motion)
    if frames_m is None or ft_m is None:
        raise ValueError(f"{filename}: missing Frames/Frame Time in MOTION section")
    file_nframes = int(frames_m.group(1))
    frametime = float(ft_m.group(1))

    motion_text = motion[ft_m.end():]
    from . import native

    values = native.parse_float_matrix(motion_text)
    if values is None:
        values = np.loadtxt(io.StringIO(motion_text), dtype=np.float64, ndmin=2)
    if start is not None and end is not None:
        values = values[start : end - 1]
    nframes = values.shape[0]

    positions = np.repeat(offsets_arr[None], nframes, axis=0).astype(np.float32)
    rotations = np.zeros((nframes, njoints, 3), dtype=np.float32)

    total = sum(channels_per_joint)
    if values.shape[1] != total:
        raise ValueError(
            f"{filename}: motion row has {values.shape[1]} values, header declares {total}"
        )

    col = 0
    for j in range(njoints):
        n = channels_per_joint[j]
        block = values[:, col : col + n]
        if n == 3:
            rotations[:, j] = block
        elif n == 6:
            positions[:, j] = block[:, 0:3]
            rotations[:, j] = block[:, 3:6]
        elif n == 9:
            # offset position + rotation + per-axis scale applied to position
            positions[:, j] = positions[:, j] + block[:, 0:3] * block[:, 6:9]
            rotations[:, j] = block[:, 3:6]
        else:
            raise ValueError(f"{filename}: unsupported channel count {n}")
        col += n

    return {
        "rotations": rotations,
        "positions": positions,
        "offsets": offsets_arr,
        "parents": parents_arr,
        "names": names,
        "order": detected_order,
        "frametime": frametime,
    }


def _split_sections(text):
    idx = text.find("MOTION")
    if idx < 0:
        raise ValueError("no MOTION section in BVH")
    return text[:idx], text[idx:]


def save(filename, data, translations=False):
    """Serialize an animation dict back to BVH.

    Root gets 6 channels (position + rotation); other joints 3 channels
    unless ``translations``; childless joints get a zero End Site — the same
    on-disk shape the reference writer produces (anim/bvh.py:137-234).
    """
    rots = np.asarray(data["rotations"])
    poss = np.asarray(data["positions"])
    offsets = np.asarray(data["offsets"])
    parents = np.asarray(data["parents"])
    names = data.get("names") or [f"joint_{i}" for i in range(len(parents))]
    order = data.get("order", "zyx")
    frametime = data.get("frametime", 1.0 / 60.0)
    rot_channels = " ".join(f"{a.upper()}rotation" for a in order)

    children: dict[int, list[int]] = {i: [] for i in range(len(parents))}
    for i, p in enumerate(parents):
        if p >= 0:
            children[int(p)].append(i)

    lines: list[str] = []
    jseq: list[int] = []

    def emit_joint(i, depth, is_root):
        t = "\t" * depth
        kw = "ROOT" if is_root else "JOINT"
        jseq.append(i)
        lines.append(f"{t}{kw} {names[i]}")
        lines.append(f"{t}{{")
        t2 = "\t" * (depth + 1)
        lines.append(f"{t2}OFFSET %f %f %f" % tuple(offsets[i]))
        if is_root or translations:
            lines.append(f"{t2}CHANNELS 6 Xposition Yposition Zposition {rot_channels}")
        else:
            lines.append(f"{t2}CHANNELS 3 {rot_channels}")
        if children[i]:
            for c in children[i]:
                emit_joint(c, depth + 1, False)
        else:
            lines.append(f"{t2}End Site")
            lines.append(f"{t2}{{")
            lines.append(f"{t2}\tOFFSET %f %f %f" % (0.0, 0.0, 0.0))
            lines.append(f"{t2}}}")
        lines.append(f"{t}}}")

    lines.append("HIERARCHY")
    emit_joint(0, 0, True)
    lines.append("MOTION")
    lines.append(f"Frames: {len(rots)}")
    lines.append(f"Frame Time: %f" % frametime)

    # vectorized motion rows
    cols = []
    for j in jseq:
        if translations or j == 0:
            cols.append(poss[:, j])
        cols.append(rots[:, j])
    motion = np.concatenate(cols, axis=1)
    from . import native

    body = native.format_float_matrix(motion)
    if body is None:
        body = _motion_text(motion)

    with open(filename, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode())
        f.write(body)


def _motion_text(motion):
    """The motion block as '%f' rows, in Python: the path without the
    native formatter, and the text it must equal."""
    return "".join(" ".join("%f" % v for v in row) + "\n" for row in motion).encode()
