"""Blender-exporter node-graph logic tests (tools/blender_exporter.py).

bpy is unavailable here, so the material extraction and mesh shaping are
driven with duck-typed stub node graphs — the extraction contract is the
reference exporter's (Blend/exporter.py:12-179)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from blender_exporter import (  # noqa: E402
    camera_entry,
    classify_mesh,
    find_texture,
    find_tint,
    material_from_nodes,
    material_from_object,
    mesh_entry,
)


# --- stub node graph ---------------------------------------------------------

class Sock:
    def __init__(self, default=None, links=()):
        self.default_value = default
        self.links = list(links)

    @property
    def is_linked(self):
        return bool(self.links)


class Link:
    def __init__(self, from_node):
        self.from_node = from_node


class Inputs:
    """Socket collection supporting both name and index access."""

    def __init__(self, named=None, ordered=None):
        self.named = named or {}
        self.ordered = ordered if ordered is not None else list(self.named.values())

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.ordered[key]
        return self.named[key]

    def __len__(self):
        return len(self.ordered)

    def __contains__(self, key):
        return key in self.named

    def __iter__(self):
        return iter(self.ordered)


class Node:
    def __init__(self, type, named=None, ordered=None, image=None):
        self.type = type
        self.inputs = Inputs(named, ordered)
        self.image = image


class Image:
    def __init__(self, filepath, name="img"):
        self.filepath = filepath
        self.name = name


def tex_node(path):
    return Node("TEX_IMAGE", image=Image(path))


# --- material extraction -----------------------------------------------------

def test_principled_plain():
    n = Node("BSDF_PRINCIPLED", named={
        "Base Color": Sock([0.2, 0.4, 0.6, 1.0]),
        "Roughness": Sock(0.25),
        "Metallic": Sock(0.7),
        "Transmission Weight": Sock(0.1),
        "IOR": Sock(1.33),
    })
    m = material_from_nodes([n])
    assert m["diffuse_color"] == [0.2, 0.4, 0.6]
    assert m["roughness"] == 0.25
    assert m["reflectivity"] == 0.7
    assert m["transparency"] == 0.1
    assert m["refractive_index"] == 1.33
    assert m["texture_file"] == ""


def test_principled_texture_direct():
    tex = tex_node("/assets/wood.png")
    n = Node("BSDF_PRINCIPLED", named={
        "Base Color": Sock([1, 1, 1, 1], links=[Link(tex)]),
        "Roughness": Sock(0.5),
        "Metallic": Sock(0.0),
        "IOR": Sock(1.45),
    })
    m = material_from_nodes([n])
    assert m["texture_file"] == "wood.png"
    # Linked base color with no MixRGB: tint-neutral white.
    assert m["diffuse_color"] == [1.0, 1.0, 1.0]


def test_principled_multiply_tint():
    """Texture * flat color through a MixRGB: the flat input is the tint
    (Blend/exporter.py:70-95)."""
    tex = tex_node("tex2.jpg")
    mix = Node("MIX_RGB", ordered=[
        Sock(0.5),                              # Fac
        Sock([1, 1, 1, 1], links=[Link(tex)]),  # input 1 = texture
        Sock([1.0, 0.5, 0.25, 1.0]),            # input 2 = tint
    ])
    n = Node("BSDF_PRINCIPLED", named={
        "Base Color": Sock([1, 1, 1, 1], links=[Link(mix)]),
        "Roughness": Sock(0.5),
        "Metallic": Sock(0.0),
    })
    m = material_from_nodes([n])
    assert m["texture_file"] == "tex2.jpg"
    assert m["diffuse_color"] == [1.0, 0.5, 0.25]


def test_tint_other_orientation():
    tex = tex_node("a.png")
    mix = Node("MIX_RGB", ordered=[
        Sock(0.5),
        Sock([0.9, 0.8, 0.7, 1.0]),             # input 1 = tint
        Sock([1, 1, 1, 1], links=[Link(tex)]),  # input 2 = texture
    ])
    assert find_tint(Sock(None, links=[Link(mix)])) == [0.9, 0.8, 0.7]


def test_texture_through_bump_chain():
    tex = tex_node("bumpy.ppm")
    bump = Node("BUMP", named={"Height": Sock(0.0, links=[Link(tex)])})
    sock = Sock(None, links=[Link(bump)])
    assert find_texture(sock) == "bumpy.ppm"


def test_glass_bsdf():
    n = Node("BSDF_GLASS", named={
        "Color": Sock([0.9, 0.95, 1.0, 1.0]),
        "Roughness": Sock(0.05),
        "IOR": Sock(1.52),
    })
    m = material_from_nodes([n])
    assert m["transparency"] == 1.0
    assert m["refractive_index"] == 1.52
    assert m["roughness"] == 0.05
    assert m["specular_color"] == [1.0, 1.0, 1.0]
    assert m["diffuse_color"] == [0.9, 0.95, 1.0]


def _mix_shader_graph(fac, glossy_first):
    diffuse = Node("BSDF_DIFFUSE", named={
        "Color": Sock([0.6, 0.3, 0.2, 1.0]),
        "Normal": Sock(None),
    })
    glossy = Node("BSDF_GLOSSY", named={
        "Color": Sock([1.0, 0.9, 0.8, 1.0]),
        "Roughness": Sock(0.1),
    })
    first, second = (glossy, diffuse) if glossy_first else (diffuse, glossy)
    mix = Node("MIX_SHADER", named={"Fac": Sock(fac)}, ordered=[
        Sock(fac),
        Sock(None, links=[Link(first)]),
        Sock(None, links=[Link(second)]),
    ])
    mix.inputs.named["Fac"] = mix.inputs.ordered[0]
    return [diffuse, glossy, mix]


def test_mix_shader_glossy_first():
    """Glossy on Mix input 1: Fac weights the second (diffuse) shader, so
    k_specular = 1 - Fac (Blend/exporter.py:150-172)."""
    m = material_from_nodes(_mix_shader_graph(0.7, glossy_first=True))
    assert abs(m["k_specular"] - 0.3) < 1e-9
    assert abs(m["k_diffuse"] - 0.7) < 1e-9
    assert abs(m["reflectivity"] - 0.3) < 1e-9
    assert m["specular_color"] == [1.0, 0.9, 0.8]
    assert m["roughness"] == 0.1
    assert m["diffuse_color"] == [0.6, 0.3, 0.2]


def test_mix_shader_diffuse_first():
    m = material_from_nodes(_mix_shader_graph(0.7, glossy_first=False))
    assert abs(m["k_specular"] - 0.7) < 1e-9
    assert abs(m["k_diffuse"] - 0.3) < 1e-9
    assert abs(m["reflectivity"] - 0.7) < 1e-9


def test_glossy_without_mix_is_mirror():
    glossy = Node("BSDF_GLOSSY", named={
        "Color": Sock([1, 1, 1, 1]),
        "Roughness": Sock(0.0),
    })
    m = material_from_nodes([glossy])
    assert m["k_specular"] == 1.0
    assert m["k_diffuse"] == 0.0
    assert m["reflectivity"] == 1.0


def test_diffuse_texture_via_normal_bump():
    """Texture reachable only through the Normal/Bump input is still found
    (Blend/exporter.py:140-146)."""
    tex = tex_node("n.png")
    bump = Node("BUMP", named={"Height": Sock(0.0, links=[Link(tex)])})
    diffuse = Node("BSDF_DIFFUSE", named={
        "Color": Sock([0.5, 0.5, 0.5, 1.0]),
        "Normal": Sock(None, links=[Link(bump)]),
    })
    m = material_from_nodes([diffuse])
    assert m["texture_file"] == "n.png"
    assert m["diffuse_color"] == [0.5, 0.5, 0.5]


def test_defaults_when_no_nodes():
    m = material_from_nodes(())
    assert m["diffuse_color"] == [0.8, 0.8, 0.8]
    assert m["k_diffuse"] == 0.9
    assert m["k_specular"] == 0.3
    assert m["reflectivity"] == 0.0


# --- object shaping ----------------------------------------------------------

class Vec3(tuple):
    pass


class Matrix:
    def __init__(self, translation):
        self.translation = Vec3(translation)


class MeshData:
    def __init__(self, materials=()):
        self.materials = list(materials)


class Obj:
    def __init__(self, name, loc, scale=(1, 1, 1), dims=(2, 2, 2)):
        self.name = name
        self.type = "MESH"
        self.matrix_world = Matrix(loc)
        self.rotation_euler = (0.0, 0.3, 0.0)
        self.scale = scale
        self.dimensions = dims
        self.data = MeshData()
        self.animation_data = None


def test_classify_and_mesh_entries():
    assert classify_mesh("Sphere.001") == "spheres"
    assert classify_mesh("BigCube") == "cubes"
    assert classify_mesh("Plane") == "rectangles"
    assert classify_mesh("Suzanne") is None

    s = mesh_entry(Obj("Sphere", (1, 2, 3), dims=(4, 4, 4)), "spheres")
    assert s["location"] == [1, 2, 3]
    assert s["scale"] == [2.0, 2.0, 2.0]  # dimensions / 2
    assert s["velocity"] == [0.0, 0.0, 0.0]
    assert s["material"]["k_diffuse"] == 0.9

    # Cubes and rectangles export Blender DIMENSIONS (actual world size),
    # not obj.scale: the default cube mesh is 2 m per side, so
    # dimensions = 2 * scale (reference Blend/exporter.py:206-236).
    c = mesh_entry(Obj("Cube", (0, 0, 0), scale=(1.5, 2.5, 3.5),
                       dims=(3.0, 5.0, 7.0)), "cubes")
    assert c["translation"] == [0, 0, 0]
    assert c["scale"] == [3.0, 5.0, 7.0]

    r = mesh_entry(Obj("Plane", (0, 0, -1), scale=(3.0, 4.0, 1.0),
                       dims=(6.0, 8.0, 0.0)), "rectangles")
    assert r["scale"] == [6.0, 8.0, 1.0]


class Dof:
    def __init__(self):
        self.aperture_fstop = 2.8  # must NOT be exported (an f-number)
        self.focus_distance = 7.5
        self.use_dof = True


class CamData:
    def __init__(self):
        self.lens = 50.0
        self.sensor_width = 36.0
        self.sensor_height = 24.0
        self.dof = Dof()


class CamObj:
    def __init__(self, props=None):
        self.type = "CAMERA"
        self.matrix_world = Matrix((1.0, -2.0, 3.0))
        self.data = CamData()
        self._props = props or {}

    def get(self, key, default=None):  # bpy custom-property access
        return self._props.get(key, default)


def test_camera_entry_aperture_custom_property():
    """`aperture` comes from the object's custom property in lens-diameter
    units (reference Blend/exporter.py:256; Code/camera.cpp:144-178 uses
    aperture/2 as the disk radius) — never from dof.aperture_fstop."""
    gaze, up = (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)

    e = camera_entry(CamObj({"aperture": 0.35}), gaze, up)
    assert e["aperture"] == 0.35
    assert e["focus_dist"] == 7.5
    assert e["focal_length"] == 50.0
    assert e["location"] == [1.0, -2.0, 3.0]

    # No custom property -> pinhole (0.0), even though use_dof is on and
    # an f-stop exists: the f-number must never leak into the schema.
    e = camera_entry(CamObj(), gaze, up)
    assert e["aperture"] == 0.0


def test_material_from_object_no_slots():
    m = material_from_object(Obj("Cube", (0, 0, 0)))
    assert m == material_from_nodes(())


def test_exported_material_loads():
    """The exported dict round-trips through the scene loader."""
    from ray_tracying.scene.loader import load_scene_dict

    mat = material_from_nodes(_mix_shader_graph(0.6, glossy_first=True))
    mat.pop("texture_file")  # no texture files on disk in this test
    d = {
        "cameras": [{
            "location": [0, 0, 0], "gaze_vector": [0, 1, 0],
            "up_vector": [0, 0, 1], "focal_length": 35.0,
            "sensor_width": 36.0, "sensor_height": 24.0,
        }],
        "render": {"resolution_x": 8, "resolution_y": 8},
        "spheres": [{"location": [0, 5, 0], "radius": 1.0, "material": mat}],
        "lights": [{"location": [0, 0, 5], "color": [1, 1, 1],
                    "intensity": 100.0}],
    }
    s = load_scene_dict(d)
    assert s.n_geoms == 1
    assert abs(float(s.materials.reflectivity[0]) - 0.4) < 1e-6


# ---------------------------------------------------------------------------
# Field-inventory differential vs the reference exporter's ACTUAL output
# ---------------------------------------------------------------------------

REFERENCE_SCENE_JSON = "/root/reference/ASCII/scene.json"


@pytest.mark.skipif(
    not os.path.exists(REFERENCE_SCENE_JSON),
    reason="reference checkout not mounted",
)
def test_exporter_field_inventory_matches_reference_output():
    """Blender is unavailable in this environment, so end-to-end export
    can't run — instead, pin the repo exporter's emitted KEY SETS against
    the reference exporter's actual committed output
    (/root/reference/ASCII/scene.json, written by Blend/exporter.py:
    181-295).  Every entry constructor must produce exactly the keys the
    reference writes, with the reference's unit conventions."""
    import json as _json

    ref = _json.load(open(REFERENCE_SCENE_JSON))

    # camera entry: same keys as the reference's cameras[0]
    gaze, up = (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    cam = camera_entry(CamObj({"aperture": 0.25}), gaze, up)
    assert set(cam) == set(ref["cameras"][0]), (
        set(cam) ^ set(ref["cameras"][0])
    )

    # light entry shape (reference lights[0]): the exporter builds it
    # inline in export_scene; replicate the dict literal it writes.
    light = {
        "location": [0.0, 0.0, 3.0],
        "color": [1.0, 1.0, 1.0],
        "intensity": 1000.0,
        "radius": 0.0,
    }
    assert set(light) == set(ref["lights"][0])

    # cube / rectangle entries + their material blocks
    cube = mesh_entry(Obj("Cube", (0.0, 0.0, 0.0)), "cubes")
    assert set(cube) == set(ref["cubes"][0]), set(cube) ^ set(ref["cubes"][0])
    rect = mesh_entry(Obj("Plane", (0.0, 0.0, 0.0)), "rectangles")
    assert set(rect) == set(ref["rectangles"][0])
    assert set(cube["material"]) == set(ref["cubes"][0]["material"]), (
        set(cube["material"]) ^ set(ref["cubes"][0]["material"])
    )

    # sphere entry: the bundled scene has no spheres, so pin against the
    # reference exporter's code inventory (Blend/exporter.py:186-203):
    # location/rotation/scale/velocity/material, scale = dimensions/2.
    sph = mesh_entry(Obj("Sphere", (0.0, 0.0, 0.0)), "spheres")
    assert set(sph) == {"location", "rotation", "scale", "velocity",
                       "material"}

    # unit conventions the loader depends on
    assert isinstance(ref["render"]["resolution_x"], int)
    assert set(ref["render"]) == {"resolution_x", "resolution_y"}
    # reference cameras carry aperture in lens-diameter units with 0 =
    # pinhole; our camera_entry defaults identically
    assert camera_entry(CamObj(), gaze, up)["aperture"] == 0.0
