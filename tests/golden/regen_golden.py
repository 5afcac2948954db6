"""Regenerate the re-encodable golden fixtures after an INTENTIONAL format
change (run from the repo root: `python tests/golden/regen_golden.py`).

Policy (see tests/test_golden.py): the previous fixture for every regenerated
name is preserved as `<name>_legacy<tag>.z` with `decode_only: true` — old
containers must stay decodable forever. Reconstruction hashes must NOT change
(the coded values are format-independent); the script refuses to proceed if
they do.
"""

import hashlib
import json
import pathlib
import shutil
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import dctz_tpu  # noqa: E402
from dctz_tpu.config import CodecConfig  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent
MANIFEST_PATH = GOLDEN / "manifest.json"

# Must mirror test_golden.py::test_reencode_matches_golden
CONFIGS = {
    "golden_v1_ec_f64": dict(mode="ec", container="v1"),
    "golden_v1_qt_f64": dict(mode="qt", container="v1"),
    "golden_v2_ec_f32": dict(
        mode="ec", container="v2", chunk_bytes=2048, ids_codec="deflate"
    ),
    "golden_v2_qt_f32": dict(
        mode="qt", container="v2", chunk_bytes=2048, ids_codec="deflate"
    ),
    "golden_v2_ec_f32_rans": dict(
        mode="ec", container="v2", chunk_bytes=2048, ids_codec="rans"
    ),
    "golden_v2_ec_f32_dpk": dict(
        mode="ec", container="v2", chunk_bytes=2048, ids_codec="device"
    ),
    "golden_v2_qt_f32_dpk": dict(
        mode="qt", container="v2", chunk_bytes=2048, ids_codec="device"
    ),
    # the DC-delta state (Header.dcd) — opt-in (cfg.dc_delta; measured a
    # wash on the available workloads) but both flag
    # states stay golden-pinned
    "golden_v2_ec_f32_dpk_dcd": dict(
        mode="ec", container="v2", chunk_bytes=2048, ids_codec="device",
        dc_delta=True,
    ),
}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def main(legacy_tag: str) -> None:
    manifest = json.loads(MANIFEST_PATH.read_text())
    x64 = np.fromfile(GOLDEN / "golden_input_f64.bin", np.float64)
    changed = 0
    for name, cfgkw in CONFIGS.items():
        x = x64.astype(np.float32) if manifest[name]["dtype"] == "float32" else x64
        blob = dctz_tpu.compress(x, config=CodecConfig(error_bound=1e-3, **cfgkw))
        if _sha(blob) == manifest[name]["blob_sha256"]:
            continue
        y = dctz_tpu.decompress(blob)
        rs = _sha(np.asarray(y).tobytes())
        assert rs == manifest[name]["recon_sha256"], (
            f"{name}: RECONSTRUCTION changed ({rs}) — this is a semantics "
            "change, not a format change; fix the code instead"
        )
        legacy = f"{name}_legacy{legacy_tag}"
        if legacy not in manifest:
            shutil.copy(GOLDEN / f"{name}.z", GOLDEN / f"{legacy}.z")
            manifest[legacy] = {
                **{k: manifest[name][k] for k in ("dtype", "n")},
                "blob_sha256": manifest[name]["blob_sha256"],
                "recon_sha256": manifest[name]["recon_sha256"],
                "decode_only": True,
                "note": f"pre-{legacy_tag} encoder output, decode-only",
            }
        (GOLDEN / f"{name}.z").write_bytes(blob)
        manifest[name]["blob_sha256"] = _sha(blob)
        changed += 1
        print(f"regenerated {name} ({len(blob)} bytes), kept {legacy}")
    MANIFEST_PATH.write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"{changed} fixtures regenerated")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: regen_golden.py <legacy-tag>  (e.g. 'plc')")
    main(sys.argv[1])
