"""BVH -> FBX batch export through Autodesk MotionBuilder (a copy of
`zeggs_tpu/cli/bvh2fbx.py`).

The reference renders results by importing BVH + WAV into a MotionBuilder
character template. That needs MotionBuilder's `pyfbsdk`, which exists only
inside MotionBuilder's Python; without it `bvh2fbx` raises RuntimeError.

Usage (inside MotionBuilder's mobupy, or with pyfbsdk on sys.path):
  python -m zeggs_tpu_torch.cli.bvh2fbx --input-dir results/ --template Male.fbx
"""

from __future__ import annotations

import argparse
from pathlib import Path


def bvh2fbx(bvh_file, audio_file, template_fbx, output_fbx, fps=60):
    """Open the character template, import the BVH at ``fps``, attach the
    audio track, save as FBX."""
    try:
        import pyfbsdk as fb  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "bvh2fbx requires Autodesk MotionBuilder's pyfbsdk; run inside "
            "MotionBuilder (mobupy) or skip FBX export"
        ) from e

    app = fb.FBApplication()
    app.FileOpen(str(template_fbx))
    system = fb.FBSystem()
    scene = system.Scene
    scene.Evaluate()
    if audio_file is not None:
        fb.FBAudioClip(str(audio_file))
    options = fb.FBFbxOptions(True)
    options.SetAll(fb.FBElementAction.kFBElementActionMerge, True)
    app.FileImport(str(bvh_file), True)
    fb.FBPlayerControl().SetTransportFps(fb.FBTimeMode.kFBTimeModeCustom, float(fps))
    app.FileSave(str(output_fbx))


def main(argv=None):
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.bvh2fbx")
    p.add_argument("--input-dir", required=True, help="directory of <name>.bvh [+ <name>.wav]")
    p.add_argument("--template", required=True, help="character template FBX")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--fps", type=float, default=60)
    args = p.parse_args(argv)

    in_dir = Path(args.input_dir)
    out_dir = Path(args.output_dir) if args.output_dir else in_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    for bvh_file in sorted(in_dir.glob("*.bvh")):
        wav = bvh_file.with_suffix(".wav")
        bvh2fbx(
            bvh_file,
            wav if wav.exists() else None,
            args.template,
            out_dir / (bvh_file.stem + ".fbx"),
            args.fps,
        )
        print(f"exported {bvh_file.stem}.fbx")


if __name__ == "__main__":
    main()
