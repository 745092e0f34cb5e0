#!/usr/bin/env python3
"""Blender -> scene.json exporter (the counterpart of the reference's
Blend/exporter.py, reimplemented — not copied — against the same JSON
schema so .blend assets flow into ray_tracying).

Run headless:  blender --background scene.blend --python blender_exporter.py
Output:        scene.json next to the .blend (or $RTT_EXPORT_PATH)

Schema produced (matches scene/loader.py = reference json_loader.cpp):
  cameras[0]: location, gaze_vector, up_vector, focal_length,
              sensor_width/height, aperture, focus_dist
  render:     resolution_x/y
  lights:     location, color, intensity, radius
  spheres:    location, rotation, scale, velocity, material
  cubes:      translation, rotation, scale, material
  rectangles: translation, rotation, scale, material
  planes:     corners[4], material

Object classification follows the reference's name-based convention
(reference Blend/exporter.py:186-245): object names containing "Sphere"
export as spheres, "Cube" as cubes, "Plane" as rectangles.

Material extraction reproduces the reference exporter's full node-graph
walk (Blend/exporter.py:12-179):
  - Principled BSDF: base color / roughness / metallic->reflectivity /
    transmission->transparency / IOR, texture found recursively through
    Mix/Math/Bump chains, and the multiply-TINT color recovered from a
    MixRGB node feeding Base Color (the non-texture input).
  - Glass BSDF: color, transparency 1, IOR, roughness.
  - Diffuse+Glossy Mix Shader: Fac -> k_diffuse/k_specular/reflectivity
    (orientation-aware: which shader feeds the Mix's first socket), glossy
    color -> specular, texture searched in the Diffuse Color and Normal
    (bump) inputs.

Everything below `material_from_nodes` is bpy-independent and duck-typed
(tests/test_exporter.py drives it with stub node graphs); only the
`export_scene` glue touches bpy.
"""

import json
import math
import os

try:
    import bpy  # type: ignore
except ImportError:  # pragma: no cover - only runs inside Blender
    bpy = None


def _vec(v):
    return [float(v[0]), float(v[1]), float(v[2])]


# ---------------------------------------------------------------------------
# Node-graph material extraction (bpy-independent, duck-typed)
# ---------------------------------------------------------------------------

# Defaults the reference exporter writes when a slot/tree is absent
# (Blend/exporter.py:18-29).  NOTE these differ from the *loader* defaults
# (json_loader.cpp / material.hpp) — the exporter always writes every key,
# so its defaults are the authoritative ones for exported scenes.
EXPORT_MATERIAL_DEFAULTS = {
    "diffuse_color": [0.8, 0.8, 0.8],
    "specular_color": [0.0, 0.0, 0.0],
    "roughness": 0.5,
    "k_ambient": 0.1,
    "k_diffuse": 0.9,
    "k_specular": 0.3,
    "reflectivity": 0.0,
    "transparency": 0.0,
    "refractive_index": 1.0,
    "texture_file": "",
}


def _socket(node, name):
    """Input socket by name, or None (sockets vary across Blender versions)."""
    try:
        return node.inputs[name]
    except (KeyError, IndexError, TypeError):
        return None


def _socket_color(node, name, fallback=(1.0, 1.0, 1.0)):
    s = _socket(node, name)
    if s is None:
        return list(fallback)
    return [float(c) for c in list(s.default_value)[:3]]


def _linked_node(sock):
    return sock.links[0].from_node if (sock is not None and sock.is_linked) else None


def find_texture(sock, depth=0):
    """Image-texture filename reachable from an input socket, following
    Bump-Height and the first two inputs of Mix/Math/MixShader nodes
    (reference Blend/exporter.py:47-68).  "" when none."""
    if depth > 8:
        return ""
    node = _linked_node(sock)
    if node is None:
        return ""
    if node.type == "TEX_IMAGE" and getattr(node, "image", None):
        return os.path.basename(node.image.filepath or node.image.name)
    if node.type == "BUMP":
        return find_texture(_socket(node, "Height"), depth + 1)
    if node.type in ("MIX_RGB", "MATH", "MIX_SHADER"):
        for i in range(min(2, len(node.inputs))):
            found = find_texture(node.inputs[i], depth + 1)
            if found:
                return found
    return ""


def find_tint(sock):
    """Multiply-tint color: when a MixRGB node feeds the socket with a
    texture on one input and a flat color on the other, the flat color is
    the tint (the renderer multiplies texel * diffuse,
    Code/material.hpp:122-133; extraction per Blend/exporter.py:70-95).
    Unlinked sockets report their own color; unknown topologies report
    white (tint-neutral)."""
    if sock is None:
        return [1.0, 1.0, 1.0]
    if not sock.is_linked:
        return [float(c) for c in list(sock.default_value)[:3]]
    node = sock.links[0].from_node
    if node.type == "MIX_RGB" and len(node.inputs) >= 3:
        a, b = node.inputs[1], node.inputs[2]
        if a.is_linked and not b.is_linked:
            return [float(c) for c in list(b.default_value)[:3]]
        if b.is_linked and not a.is_linked:
            return [float(c) for c in list(a.default_value)[:3]]
    return [1.0, 1.0, 1.0]


def material_from_nodes(nodes):
    """Material dict from a node list (duck-typed; see module docstring).

    Shader priority mirrors the reference exporter: Principled wins, then
    Glass, then the Diffuse(+Glossy(+Mix)) combination
    (Blend/exporter.py:97-177)."""
    mat = dict(EXPORT_MATERIAL_DEFAULTS)
    mat["diffuse_color"] = list(mat["diffuse_color"])
    mat["specular_color"] = list(mat["specular_color"])

    by_type = {}
    for n in nodes:
        by_type.setdefault(n.type, n)

    principled = by_type.get("BSDF_PRINCIPLED")
    if principled is not None:
        base = _socket(principled, "Base Color")
        mat["diffuse_color"] = find_tint(base)
        rough = _socket(principled, "Roughness")
        if rough is not None:
            mat["roughness"] = float(rough.default_value)
        metal = _socket(principled, "Metallic")
        if metal is not None:
            mat["reflectivity"] = float(metal.default_value)
        for key in ("Transmission Weight", "Transmission"):
            s = _socket(principled, key)
            if s is not None:
                mat["transparency"] = float(s.default_value)
                break
        ior = _socket(principled, "IOR")
        if ior is not None:
            mat["refractive_index"] = float(ior.default_value)
        mat["texture_file"] = find_texture(base)
        return mat

    glass = by_type.get("BSDF_GLASS")
    if glass is not None:
        mat["diffuse_color"] = _socket_color(glass, "Color")
        mat["specular_color"] = [1.0, 1.0, 1.0]
        mat["transparency"] = 1.0
        ior = _socket(glass, "IOR")
        if ior is not None:
            mat["refractive_index"] = float(ior.default_value)
        rough = _socket(glass, "Roughness")
        if rough is not None:
            mat["roughness"] = float(rough.default_value)
        return mat

    diffuse = by_type.get("BSDF_DIFFUSE")
    glossy = by_type.get("BSDF_GLOSSY")
    mix = by_type.get("MIX_SHADER")

    if diffuse is not None:
        color_in = _socket(diffuse, "Color")
        mat["texture_file"] = find_texture(color_in)
        if not mat["texture_file"]:
            normal_in = _socket(diffuse, "Normal")
            if normal_in is not None and normal_in.is_linked:
                mat["texture_file"] = find_texture(normal_in)
        mat["diffuse_color"] = find_tint(color_in)

    if glossy is not None:
        mat["specular_color"] = _socket_color(glossy, "Color")
        rough = _socket(glossy, "Roughness")
        if rough is not None:
            mat["roughness"] = float(rough.default_value)
        if mix is not None:
            fac_sock = _socket(mix, "Fac")
            fac = float(fac_sock.default_value) if fac_sock is not None else 0.5
            # Mix output = (1-Fac)*input1 + Fac*input2: when the glossy
            # shader feeds input 1, Fac is the DIFFUSE weight.
            glossy_first = False
            if len(mix.inputs) > 1:
                for link in mix.inputs[1].links:
                    if link.from_node is glossy:
                        glossy_first = True
                        break
            k_spec = (1.0 - fac) if glossy_first else fac
            mat["k_specular"] = k_spec
            mat["k_diffuse"] = 1.0 - k_spec
            mat["reflectivity"] = k_spec
        else:
            # Pure glossy: a mirror.
            mat["k_specular"] = 1.0
            mat["k_diffuse"] = 0.0
            mat["reflectivity"] = 1.0

    return mat


def material_from_object(obj):
    """Material dict for a Blender object (slot 0, node tree when present)."""
    mats = getattr(getattr(obj, "data", None), "materials", None)
    if not mats or not mats[0]:
        return material_from_nodes(())
    m = mats[0]
    if not getattr(m, "use_nodes", False) or not getattr(m, "node_tree", None):
        flat = material_from_nodes(())
        flat["diffuse_color"] = _vec(m.diffuse_color[:3])
        return flat
    return material_from_nodes(m.node_tree.nodes)


# ---------------------------------------------------------------------------
# Object classification / shaping (bpy-independent given duck-typed objects)
# ---------------------------------------------------------------------------

def classify_mesh(name):
    """Name-based kind convention (reference Blend/exporter.py:186-245)."""
    if "Sphere" in name:
        return "spheres"
    if "Cube" in name:
        return "cubes"
    if "Plane" in name:
        return "rectangles"
    return None


def mesh_entry(obj, kind):
    """JSON entry for one mesh object of the given kind."""
    loc = _vec(obj.matrix_world.translation)
    rot = [float(a) for a in obj.rotation_euler]
    mat = material_from_object(obj)
    if kind == "spheres":
        # Blender dimensions = diameter; unit sphere radius = 1, so
        # scale = dimensions / 2 (reference Blend/exporter.py:186-203).
        dims = obj.dimensions
        vel = obj.get("velocity", [0.0, 0.0, 0.0]) if hasattr(obj, "get") \
            else [0.0, 0.0, 0.0]
        return {
            "location": loc,
            "rotation": rot,
            "scale": [float(dims[0]) / 2, float(dims[1]) / 2, float(dims[2]) / 2],
            "velocity": [float(v) for v in vel],
            "material": mat,
        }
    if kind == "cubes":
        # Unit cube is size 1 and Blender dimensions are the actual size, so
        # scale = dimensions — NOT obj.scale: the default cube mesh is 2 m per
        # side, dimensions = 2 * scale (reference Blend/exporter.py:206-223).
        dims = obj.dimensions
        return {
            "translation": loc,
            "rotation": rot,
            "scale": [float(x) for x in dims],
            "material": mat,
        }
    # rectangles: scale = dimensions, z slot fixed at 1
    # (reference Blend/exporter.py:226-236).
    dims = obj.dimensions
    return {
        "translation": loc,
        "rotation": rot,
        "scale": [float(dims[0]), float(dims[1]), 1.0],
        "material": mat,
    }


def camera_entry(obj, gaze, up):
    """Camera JSON entry from a camera object plus world-space gaze/up.

    `aperture` is read from an `aperture` CUSTOM PROPERTY on the camera
    object, in lens-DIAMETER units — the renderer samples the thin-lens
    origin on a disk of radius aperture/2 (reference Code/camera.cpp:144-178)
    and the reference exporter reads the same custom property (reference
    Blend/exporter.py:256).  `cam.dof.aperture_fstop` would be a
    dimensionless f-number — the wrong quantity entirely."""
    cam = obj.data
    return {
        "location": _vec(obj.matrix_world.translation),
        "gaze_vector": _vec(gaze),
        "up_vector": _vec(up),
        "focal_length": float(cam.lens),
        "sensor_width": float(cam.sensor_width),
        "sensor_height": float(cam.sensor_height),
        "aperture": float(obj.get("aperture", 0.0)),
        "focus_dist": float(getattr(cam.dof, "focus_distance", 10.0)),
    }


def export_scene(out_path=None):
    assert bpy is not None, "run inside Blender: blender --background --python ..."
    scene = bpy.context.scene
    data = {"cameras": [], "lights": [], "spheres": [], "cubes": [],
            "rectangles": [], "planes": []}

    for obj in bpy.data.objects:
        if obj.type == "CAMERA":
            from mathutils import Vector

            quat = obj.matrix_world.to_quaternion()
            # Blender cameras look down -Z with +Y up in local space.
            gaze = quat @ Vector((0.0, 0.0, -1.0))
            up = quat @ Vector((0.0, 1.0, 0.0))
            data["cameras"].append(camera_entry(obj, gaze, up))
        elif obj.type == "LIGHT":
            li = obj.data
            data["lights"].append({
                "location": _vec(obj.matrix_world.translation),
                "color": _vec(li.color),
                "intensity": float(li.energy),
                "radius": float(getattr(li, "shadow_soft_size", 0.0)),
            })
        elif obj.type == "MESH":
            kind = classify_mesh(obj.name)
            if kind is None:
                continue
            entry = mesh_entry(obj, kind)
            if kind == "spheres" and obj.animation_data and obj.animation_data.action:
                # Animated spheres export a per-frame velocity.
                f0 = scene.frame_current
                scene.frame_set(f0)
                p0 = obj.matrix_world.translation.copy()
                scene.frame_set(f0 + 1)
                p1 = obj.matrix_world.translation.copy()
                scene.frame_set(f0)
                entry["velocity"] = _vec(p1 - p0)
            data[kind].append(entry)

    data["render"] = {
        "resolution_x": int(scene.render.resolution_x),
        "resolution_y": int(scene.render.resolution_y),
    }

    if out_path is None:
        out_path = os.environ.get("RTT_EXPORT_PATH")
    if out_path is None:
        base = bpy.data.filepath or "scene.blend"
        out_path = os.path.join(os.path.dirname(base), "scene.json")
    with open(out_path, "w") as f:
        json.dump(data, f, indent=1)
    print(f"exported {out_path}")


if __name__ == "__main__":
    export_scene()
