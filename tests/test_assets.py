"""Assets: registry parsing, PPM loading, GLB import + flatten, residency
budgets/eviction."""

import json
import os
import struct

import numpy as np
import pytest

from scx.assets import gltf as g
from scx.assets import registry as reg
from scx.assets import textures as tx
from scx.assets.residency import AssetManager, FALLBACK_SLOT
from scx.core.config import AssetResidencyConfig
from scx.core.prng import asset_id_from_path


def test_registry_parse(tmp_path):
    p = tmp_path / "asset_registry.txt"
    p.write_text(
        "# label|mesh_path|material_path\n"
        "Cube|meshes/cube|materials/unlit\n"
        "\n"
        "Checker|meshes/cube|materials/checker\n"
    )
    entries = reg.load_asset_registry(str(p))
    assert len(entries) == 2
    assert entries[0].label == "Cube"
    assert entries[0].mesh_id == asset_id_from_path("meshes/cube")
    assert reg.find_by_mesh_id(entries, entries[0].mesh_id).label == "Cube"


def test_ppm_p6_roundtrip(tmp_path):
    img = (np.random.RandomState(0).rand(4, 6, 3) * 255).astype(np.uint8)
    p = tmp_path / "t.ppm"
    with open(p, "wb") as fh:
        fh.write(b"P6\n# comment\n6 4\n255\n")
        fh.write(img.tobytes())
    out = tx.load_ppm(str(p))
    np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, atol=1e-6)


def _reference_root():
    """The reference engine's checkout, as BASELINE.json records it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BASELINE.json")) as fh:
        return json.load(fh)["reference_path"]


def test_reference_ppm_assets_load():
    path = os.path.join(_reference_root(), "assets/textures/checker.ppm")
    if not os.path.exists(path):
        pytest.skip(f"reference checkout not present ({path})")
    out = tx.load_image(path)
    assert out is not None and out.ndim == 3 and out.shape[2] == 3


def make_glb():
    """Synthetic 2-triangle quad GLB with a child node transform."""
    pos = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
    )
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    bin_chunk = pos.tobytes() + uv.tobytes() + idx.tobytes()
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\0" * pad
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"name": "root", "children": [1]},
            {"name": "quad", "mesh": 0, "translation": [2.0, 0.0, 0.0]},
        ],
        "meshes": [
            {
                "name": "quad",
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                        "indices": 2,
                        "material": 0,
                    }
                ],
            }
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}
        ],
        "textures": [{"source": 0}],
        "images": [{"uri": "textures/albedo.png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 32},
            {"buffer": 0, "byteOffset": 80, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(js), 0x4E4F534A) + js
    out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
    return out


def test_glb_import_and_flatten():
    model = g.load_glb(make_glb())
    assert model is not None
    assert len(model.meshes) == 1
    assert model.meshes[0].positions.shape == (4, 3)
    assert model.meshes[0].indices.tolist() == [0, 1, 2, 0, 2, 3]
    assert model.base_color_uris == ["textures/albedo.png"]

    flat = g.flatten_model_to_mesh(model)
    # child node translated +2 in x
    np.testing.assert_allclose(flat.positions[0], [2.0, 0.0, 0.0], atol=1e-6)
    bmin, bmax = g.compute_mesh_bounds(flat)
    np.testing.assert_allclose(bmin, [2.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(bmax, [3.0, 1.0, 0.0], atol=1e-6)

    verts, tris = g.mesh_to_pool_arrays(flat)
    assert verts.shape == (4, 8) and tris.shape == (2, 3)


def test_glb_rejects_garbage():
    assert g.load_glb(b"not a glb") is None


def test_residency_load_touch_evict(tmp_path):
    cfg = AssetResidencyConfig(max_loads_per_frame=2, max_resident_textures=3)
    am = AssetManager(cfg, asset_root=str(tmp_path), pool_slots=8, slot_size=16)
    # create 4 disk textures
    ids = []
    for i in range(4):
        img = (np.full((8, 8, 3), i * 60, np.uint8))
        p = tmp_path / f"t{i}.ppm"
        with open(p, "wb") as fh:
            fh.write(b"P6\n8 8\n255\n" + img.tobytes())
        ids.append(am.load_texture(f"t{i}.ppm"))
    # 2 loads/frame budget
    am.begin_frame()
    assert am.stats.loads_completed == 2
    am.begin_frame()
    am.begin_frame()
    # over count budget (3): oldest evicted
    assert am.stats.resident_textures <= 3
    assert am.stats.evictions >= 1
    # touch the oldest so the next eviction takes another
    am.touch(ids[3])
    # missing texture binds fallback in material table
    mat_slot = am.create_material("materials/test", albedo_texture=am.load_texture("missing.ppm"))
    for _ in range(3):
        am.begin_frame()
    mats = am.device_materials()
    # missing.ppm loaded as fallback pixels or bound to FALLBACK_SLOT
    assert int(mats.texture_id[mat_slot]) >= 0


def test_material_table_and_pool():
    am = AssetManager(pool_slots=4, slot_size=8)
    tid = am.add_texture_pixels("gen/checker", tx.checker_texture(16))
    slot = am.create_material("materials/checker", albedo_texture=tid)
    m0 = am.create_material("materials/unlit", albedo_texture=0)
    mats = am.device_materials()
    assert int(mats.texture_id[m0]) == -1  # vertex color only
    assert int(mats.texture_id[slot]) >= 2  # a real pool slot
    pool = am.device_pool()
    assert pool.shape == (4, 8, 8, 3)


def _write_ppm(path, value: int, size: int = 8):
    img = np.full((size, size, 3), value, np.uint8)
    with open(path, "wb") as fh:
        fh.write(f"P6\n{size} {size}\n255\n".encode() + img.tobytes())


def test_hot_reload_texture(tmp_path):
    """Touching a texture on disk and pumping the AssetDatabase rescan must
    rebind the resident slot to the new pixels (VERDICT r2 item 7;
    reference: editor_core/sc_asset_db.h:100-156 reload path)."""
    from scx.tools.asset_db import AssetDatabase

    _write_ppm(tmp_path / "wall.ppm", 10)
    _write_ppm(tmp_path / "roof.ppm", 200)
    am = AssetManager(asset_root=str(tmp_path), pool_slots=8, slot_size=16)
    tid = am.load_texture("wall.ppm")
    rid = am.load_texture("roof.ppm")
    mat = am.create_material("materials/wall", albedo_texture=tid)
    am.begin_frame()
    db = AssetDatabase(root=str(tmp_path))
    db.scan_all()

    slot = am.textures[tid].slot
    assert slot >= 0
    before = np.asarray(am.device_pool())[slot].copy()
    np.testing.assert_allclose(
        before.mean(), tx.srgb_to_linear(np.float32(10 / 255.0)), atol=2e-2
    )

    # rewrite the file with new pixels and a strictly newer mtime
    _write_ppm(tmp_path / "wall.ppm", 250)
    os.utime(tmp_path / "wall.ppm", (os.path.getmtime(tmp_path / "wall.ppm") + 5,) * 2)

    reloaded = am.process_asset_changes(db)
    assert reloaded == [tid]
    assert am.stats.reloads == 1
    after = np.asarray(am.device_pool())[slot]
    np.testing.assert_allclose(
        after.mean(), tx.srgb_to_linear(np.float32(250 / 255.0)), atol=2e-2
    )
    # material still binds the same (refreshed) slot
    mats = am.device_materials()
    assert int(mats.texture_id[mat]) == slot
    # untouched texture unchanged; second rescan is a no-op
    assert am.process_asset_changes(db) == []
    assert am.textures[rid].slot >= 0


def test_hot_reload_removed_file_evicts(tmp_path):
    from scx.tools.asset_db import AssetDatabase

    _write_ppm(tmp_path / "gone.ppm", 99)
    am = AssetManager(asset_root=str(tmp_path), pool_slots=8, slot_size=16)
    tid = am.load_texture("gone.ppm")
    mat = am.create_material("materials/gone", albedo_texture=tid)
    am.begin_frame()
    db = AssetDatabase(root=str(tmp_path))
    db.scan_all()
    os.remove(tmp_path / "gone.ppm")
    assert am.process_asset_changes(db) == []
    assert tid not in am.textures
    mats = am.device_materials()
    assert int(mats.texture_id[mat]) == FALLBACK_SLOT


def test_srgb_decode_and_sink_roundtrip(tmp_path):
    """Color art decodes sRGB->linear at load (sc_assets.cpp:197-198 format
    split) and the display sink re-encodes; a data texture loads raw."""
    # stored sRGB value 128/255 ~0.502 -> linear ~0.2158
    _write_ppm(tmp_path / "gray.ppm", 128)
    img_lin = tx.load_image(str(tmp_path / "gray.ppm"), srgb=True)
    img_raw = tx.load_image(str(tmp_path / "gray.ppm"), srgb=False)
    assert abs(float(img_raw[0, 0, 0]) - 128 / 255) < 1e-6
    assert abs(float(img_lin[0, 0, 0]) - 0.2158) < 1e-3
    # exact roundtrip through the transfer pair
    v = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8, 1)
    rt = tx.srgb_to_linear(np.asarray(tx.linear_to_srgb(v)))
    np.testing.assert_allclose(rt, v, atol=1e-5)

    # residency honors the per-texture flag
    am = AssetManager(asset_root=str(tmp_path), pool_slots=8, slot_size=8)
    t_color = am.load_texture("gray.ppm")            # srgb default
    t_data = am.load_texture("gray.ppm", srgb=False)  # same pixels, raw
    assert t_color == t_data  # same path -> same id: first record wins
    am.begin_frame()
    pool = np.asarray(am.device_pool())
    slot = am.textures[t_color].slot
    assert abs(pool[slot, 0, 0, 0] - 0.2158) < 1e-3

    # sink: a linear frame encodes back to the stored value
    from scx.app.viewer import save_frame

    frame = np.full((4, 4, 3), 0.2158, np.float32)
    p = save_frame(str(tmp_path / "out"), frame)
    if p.endswith(".ppm"):
        data = open(p, "rb").read()
        assert data[-4 * 4 * 3] in (127, 128, 129)
    else:
        from PIL import Image

        assert abs(int(np.asarray(Image.open(p))[0, 0, 0]) - 128) <= 1
