"""Regenerate `dtrenderer_tpu_torch/assets/builtin_fonts.npz`, the built-in
font atlases the package ships (assets/font.SHIPPED).

    python -m dtrenderer_tpu_torch.tools.bake_fonts [--ttf-dir DIR]

Each atlas is baked by the native TTF rasterizer from DejaVuSansMono.ttf
("mono") or DejaVuSans.ttf ("sans"), taken from DIR or, by default, from
where assets/font._find_ttf finds them (matplotlib's bundled fonts first).
Per (family, size) the file holds `<family><size>_atlas` (u8 coverage),
`<family><size>_cell` (cell_w, cell_h) and `<family><size>_advances` (f32
[95]). Needs no GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dtrenderer_tpu_torch.assets import font


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ttf-dir", default=None,
                    help="directory holding the two DejaVu TTF files")
    args = ap.parse_args()
    arrays = {}
    for size, family in font.SHIPPED:
        path = (os.path.join(args.ttf_dir, font.TTF_NAMES[family])
                if args.ttf_dir else font._find_ttf(family))
        if path is None or not os.path.isfile(path):
            raise SystemExit(f"no {font.TTF_NAMES[family]} found")
        atlas, cw, ch, adv = font.bake_ttf_arrays(path, size)
        key = f"{family}{size}"
        arrays[f"{key}_atlas"] = atlas
        arrays[f"{key}_cell"] = np.array([cw, ch], np.int32)
        arrays[f"{key}_advances"] = adv.astype(np.float32)
        print(f"{key}: {path}, atlas {atlas.shape}, cell {cw}x{ch}")
    np.savez_compressed(font.DATA_PATH, **arrays)
    print(f"wrote {font.DATA_PATH} ({os.path.getsize(font.DATA_PATH)} bytes)")


if __name__ == "__main__":
    main()
