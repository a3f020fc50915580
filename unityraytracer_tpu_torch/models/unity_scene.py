"""Unity scene importer: load the reference's ``.unity`` YAML directly.

The reference's content layer IS Unity scene files (SURVEY.md §2.3):
GameObjects carrying a ``RayTraceObject`` component register with the
renderer, typed by collider (``RayTraceObject.cs:28-39`` — a SphereCollider
makes an analytic sphere with ``radius = collider.radius * max(lossyScale)``,
anything else is a mesh), and a camera-attached ``RayTraceMaster`` holds the
render settings (``numBounces``/``numRays``, ``RayTraceMaster.cs:8-18``).
This module parses that serialization, so the reference's own
``Scene1.unity`` / ``SampleScene.unity`` (and any scene built the same way)
load without hand transcription — the hand-transcribed fixtures
(models/fixtures.py) double as the importer's ground truth in tests.

Format notes (Unity 2021.3 text serialization):
* a scene is a YAML stream of documents headed ``--- !u!<classID> &<fileID>``;
  each body is one plain mapping ``{ClassName: {fields...}}`` (the custom
  ``!u!`` tag only ever appears on the header line, so each body is plain
  YAML; this module parses the subset Unity writes itself, ``_yaml_subset``,
  and needs no YAML package);
* components reference their owner via ``m_GameObject {fileID}``; transforms
  form a hierarchy through ``m_Father`` (composed here into world TRS);
* built-in primitive meshes are referenced by well-known fileIDs
  (10202 Cube, 10206 Cylinder, 10207 Sphere, 10208 Capsule, 10210 Quad);
* script components are identified by their .meta GUID; the reference
  project's GUIDs are recognized by default, with a field-shape fallback
  (``albedoColor`` => RayTraceObject, ``numBounces`` => RayTraceMaster) so
  re-imported projects with fresh GUIDs still load.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ..camera import Camera
from ..scene import Material, SceneBuilder
from ..utils.logging import get_logger
from ..utils.math3d import quat_to_matrix
from . import primitives as P
from .skybox import sun_sky

# Script GUIDs from the reference project (Assets/Scripts/*.cs.meta).
RAYTRACE_OBJECT_GUID = "7fba285130b2c3342be00e9cfa2e3c7c"
RAYTRACE_MASTER_GUID = "b2e91413b60a86f49ac7969f1637f0cd"

_BUILTIN_MESH = {10202: "cube", 10206: "cylinder", 10207: "sphere_mesh",
                 10208: "capsule", 10210: "quad"}
_MESH_GEN = {"quad": P.quad, "cube": P.cube, "cylinder": P.cylinder,
             "capsule": P.capsule, "sphere_mesh": P.uv_sphere}

_DOC_RE = re.compile(r"^--- !u!(\d+) &(\d+)( stripped)?\s*$", re.M)


class _YamlError(ValueError):
    """A document outside the subset below (it is skipped, as a document a
    full YAML loader rejects is)."""


# YAML 1.1's implicit scalar types, as a standard loader resolves them.
_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {w: v for v, ws in ((True, "yes true on"), (False, "no false off"))
          for k in ws.split() for w in (k, k.capitalize(), k.upper())}
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\",
            "/": "/", " ": " "}


def _sexagesimal(text: str, number):
    value, base = number(0), 1
    for digit in reversed(text.split(":")):
        value += number(digit) * base
        base *= 60
    return value


def _scalar(text: str):
    """A plain (unquoted) scalar -> None, bool, int, float or str."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if text[0] in "-+.0123456789":
        if _INT_RE.match(text):
            t = text.replace("_", "")
            sign = -1 if t[0] == "-" else 1
            t = t.lstrip("+-")
            if t == "0":
                return 0
            if t.startswith("0b"):
                return sign * int(t[2:], 2)
            if t.startswith("0x"):
                return sign * int(t[2:], 16)
            if t[0] == "0":
                return sign * int(t, 8)
            if ":" in t:
                return sign * _sexagesimal(t, int)
            return sign * int(t)
        if _FLOAT_RE.match(text):
            t = text.replace("_", "").lower()
            sign = -1.0 if t[0] == "-" else 1.0
            t = t.lstrip("+-")
            if t == ".inf":
                return sign * float("inf")
            if t == ".nan":
                return float("nan")
            if ":" in t:
                return sign * _sexagesimal(t, float)
            return sign * float(t)
    return text


def _quoted(s: str, pos: int):
    """The quoted scalar that opens at ``s[pos]`` -> (str, end position)."""
    q = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":         # '' is an escaped quote
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise _YamlError(f"escape \\{e}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise _YamlError("unterminated quoted scalar")


def _flow(s: str, pos: int):
    """A flow value at ``s[pos]`` ({...}, [...], quoted or plain up to the
    next ``,``, ``}`` or ``]``) -> (value, end position)."""
    while pos < len(s) and s[pos] == " ":
        pos += 1
    if pos >= len(s):
        raise _YamlError("flow value missing")
    c = s[pos]
    if c == "{":
        out = {}
        pos += 1
        while True:
            while pos < len(s) and s[pos] in " ,":
                pos += 1
            if pos >= len(s):
                raise _YamlError("unterminated flow mapping")
            if s[pos] == "}":
                return out, pos + 1
            if s[pos] in "'\"":
                key, pos = _quoted(s, pos)
            else:
                end = pos
                while end < len(s) and s[end] not in ",}" and not (
                        s[end] == ":" and s[end + 1:end + 2] in (" ", "")):
                    end += 1
                key, pos = _scalar(s[pos:end].strip()), end
            while pos < len(s) and s[pos] == " ":
                pos += 1
            if pos < len(s) and s[pos] == ":":
                nxt = pos + 1
                while nxt < len(s) and s[nxt] == " ":
                    nxt += 1
                if nxt < len(s) and s[nxt] in ",}":
                    out[key], pos = None, nxt
                else:
                    out[key], pos = _flow(s, nxt)
            else:
                out[key] = None                # {a, b}: keys without values
    if c == "[":
        out = []
        pos += 1
        while True:
            while pos < len(s) and s[pos] in " ,":
                pos += 1
            if pos >= len(s):
                raise _YamlError("unterminated flow sequence")
            if s[pos] == "]":
                return out, pos + 1
            v, pos = _flow(s, pos)
            out.append(v)
    if c in "'\"":
        return _quoted(s, pos)
    end = pos
    while end < len(s) and s[end] not in ",}]":
        end += 1
    return _scalar(s[pos:end].strip()), end


def _open_brackets(s: str) -> int:
    """Flow brackets of ``s`` left open (quoted text skipped)."""
    depth = 0
    i = 0
    while i < len(s):
        if s[i] in "'\"":
            _, i = _quoted(s, i)
            continue
        depth += s[i] in "{["
        depth -= s[i] in "}]"
        i += 1
    return depth


_KEY_RE = re.compile(r"^((?:'(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"|[^\s'\"{\[]"
                     r"(?:[^:]|:(?!\s|$))*?))\s*:(?:\s+(.*))?$")


class _Lines:
    """The block parser over (indent, text) lines."""

    def __init__(self, body: str):
        self.lines = []
        for raw in body.splitlines():
            text = raw.strip()
            if not text or text.startswith("#") or text.startswith("%"):
                continue
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _YamlError("tab indentation")
            self.lines.append((len(raw) - len(raw.lstrip(" ")), text))
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else (-1, "")

    def value(self, text: str, indent: int):
        """The value that starts with ``text`` on the current line (already
        consumed); its continuation lines, if any, are deeper than
        ``indent``."""
        if text[0] in "{[":
            while _open_brackets(text) > 0:    # a flow value wrapped by lines
                ind, more = self.peek()
                if ind < 0:
                    raise _YamlError("unterminated flow value")
                text += " " + more
                self.i += 1
            v, end = _flow(text, 0)
            if text[end:].strip():
                raise _YamlError("text after a flow value")
            return v
        if text[0] in "'\"":
            while True:
                try:
                    v, end = _quoted(text, 0)
                    break
                except _YamlError:
                    ind, more = self.peek()
                    if ind <= indent:
                        raise
                    text += " " + more         # a quoted scalar folded
                    self.i += 1
            if text[end:].strip():
                raise _YamlError("text after a quoted scalar")
            return v
        if text[0] in "|>&*!":
            raise _YamlError("block scalars, anchors and tags are outside "
                             "the subset")
        while True:                            # a plain scalar folded
            ind, more = self.peek()
            if ind <= indent or _KEY_RE.match(more) or more.startswith("- "):
                break
            text += " " + more
            self.i += 1
        cut = text.find(" #")
        return _scalar(text[:cut].rstrip() if cut >= 0 else text)

    def block(self, indent: int):
        """The mapping or sequence whose first line is the current one, at
        ``indent``."""
        _, text = self.peek()
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def mapping(self, indent: int):
        out = {}
        while True:
            ind, text = self.peek()
            if ind != indent or text == "-" or text.startswith("- "):
                if ind > indent:
                    raise _YamlError("bad indentation")
                return out
            m = _KEY_RE.match(text)
            if not m:
                raise _YamlError(f"not a mapping entry: {text!r}")
            self.i += 1
            key = m.group(1)
            key = _quoted(key, 0)[0] if key[0] in "'\"" else _scalar(key)
            rest = (m.group(2) or "").strip()
            if rest:
                out[key] = self.value(rest, indent)
                continue
            nind, ntext = self.peek()
            if nind > indent:
                out[key] = self.block(nind)
            elif nind == indent and (ntext == "-" or ntext.startswith("- ")):
                out[key] = self.sequence(indent)   # Unity's unindented list
            else:
                out[key] = None

    def sequence(self, indent: int):
        out = []
        while True:
            ind, text = self.peek()
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise _YamlError("bad indentation")
                return out
            rest = text[1:].lstrip()
            if not rest:
                self.i += 1
                nind, _ = self.peek()
                out.append(self.block(nind) if nind > indent else None)
                continue
            inner = indent + (len(text) - len(rest))
            if rest[0] not in "{['\"" and _KEY_RE.match(rest) \
                    or rest.startswith("- "):
                # "- key: value": the item is a block that opens on this line.
                self.lines[self.i] = (inner, rest)
                out.append(self.block(inner))
            else:
                self.i += 1
                out.append(self.value(rest, indent))


def _yaml_subset(body: str):
    """Parse one document body of Unity's text serialization.

    Unity writes a narrow YAML 1.1 subset: block mappings by indentation,
    ``- `` sequences (at their key's own indentation), flow mappings and
    sequences such as ``{x: 0, y: 1, z: 0}``, ``{fileID: 123, guid: ...,
    type: 3}`` and ``[]`` (wrapped over lines when long), plain and quoted
    scalars. This parser covers that subset and resolves plain scalars as
    a YAML 1.1 loader does (null, booleans, decimal / octal / hex / binary
    / sexagesimal ints, floats that carry a dot), so it returns what
    ``yaml.safe_load`` returns on such a body. The package must not depend
    on PyYAML, which a machine that has torch need not have. Outside the
    subset (block scalars, anchors, tags, timestamps, merge keys, complex
    keys) it raises ``_YamlError``.
    """
    p = _Lines(body)
    if not p.lines:
        return None
    ind, text = p.peek()
    if text[0] in "{['\"":
        p.i += 1
        data = p.value(text, -1)
    else:
        data = p.block(ind)
    if p.i != len(p.lines):
        raise _YamlError("trailing lines")
    return data


def _parse_docs(text: str):
    """YAML stream -> {fileID: (classID, className, fields)}."""
    out = {}
    heads = list(_DOC_RE.finditer(text))
    for k, m in enumerate(heads):
        end = heads[k + 1].start() if k + 1 < len(heads) else len(text)
        body = text[m.end():end]
        try:
            data = _yaml_subset(body)
        except _YamlError:
            continue
        if isinstance(data, dict) and len(data) == 1:
            (cname, fields), = data.items()
            out[int(m.group(2))] = (int(m.group(1)), cname, fields or {})
    return out


def _v3(d, default=(0.0, 0.0, 0.0)):
    if not isinstance(d, dict):
        return default
    return (float(d.get("x", 0)), float(d.get("y", 0)), float(d.get("z", 0)))


def _color(d, default=(0.0, 0.0, 0.0)):
    if not isinstance(d, dict):
        return default
    return (float(d.get("r", 0)), float(d.get("g", 0)), float(d.get("b", 0)))


def _fid(d):
    return int(d.get("fileID", 0)) if isinstance(d, dict) else 0


def _local_matrix(tf) -> np.ndarray:
    q = tf.get("m_LocalRotation", {})
    quat = (float(q.get("x", 0)), float(q.get("y", 0)),
            float(q.get("z", 0)), float(q.get("w", 1)))
    pos = _v3(tf.get("m_LocalPosition"))
    scale = _v3(tf.get("m_LocalScale"), (1.0, 1.0, 1.0))
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_matrix(quat) @ np.diag(scale)
    m[:3, 3] = pos
    return m


def _world_matrix(tfid, docs, cache):
    if tfid in cache:
        return cache[tfid]
    _cls, _name, tf = docs[tfid]
    m = _local_matrix(tf)
    parent = _fid(tf.get("m_Father", {}))
    if parent and parent in docs:
        m = _world_matrix(parent, docs, cache) @ m
    cache[tfid] = m
    return m


def _is_script(fields, guid):
    s = fields.get("m_Script", {})
    return isinstance(s, dict) and s.get("guid") == guid


_GUID_RE = re.compile(r"^guid:\s*([0-9a-f]{32})\s*$", re.M)


def _guid_index(project_root) -> dict:
    """guid -> asset path, from the Unity project's ``.meta`` files.

    Unity pairs every asset with ``<asset>.meta`` carrying a stable
    ``guid:`` line; serialized references store that guid. One shallow walk
    of the project tree (``Assets/`` and any sibling content dirs under the
    root) builds the reverse map — only the first ~1 KB of each .meta is
    read (the guid line sits in the header).
    """
    import os

    idx = {}
    for dirpath, dirnames, filenames in os.walk(project_root):
        dirnames[:] = [d for d in dirnames
                       if d not in (".git", "Library", "Temp", "obj")]
        for fn in filenames:
            if not fn.endswith(".meta"):
                continue
            p = os.path.join(dirpath, fn)
            try:
                with open(p, "r", errors="replace") as f:
                    head = f.read(1024)
            except OSError:
                continue
            m = _GUID_RE.search(head)
            if m:
                idx[m.group(1)] = p[:-len(".meta")]
    return idx


def _project_root(scene_path) -> str:
    """Nearest ancestor of the scene that CONTAINS ``Assets`` (the Unity
    project root), else the scene's own directory."""
    import os

    d = os.path.dirname(os.path.abspath(scene_path))
    while True:
        if os.path.isdir(os.path.join(d, "Assets")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.dirname(os.path.abspath(scene_path))
        d = parent


def _resolve_mesh_guid(guid, guid_idx, log):
    """guid -> (vertices, faces, normals) via the project's .meta index.

    Matches the reference's ability to flatten ANY registered
    ``MeshFilter.sharedMesh`` (RayTraceMaster.cs:298-305): model-file
    assets resolve through their .meta guid and load with the OBJ loader.
    Returns None (caller warns-and-skips) for unresolvable guids or asset
    types the loader does not cover.
    """
    path = guid_idx.get(guid)
    if path is None:
        return None
    if not path.lower().endswith(".obj"):
        log.warn(f"unity import: mesh asset {path!r} is not an OBJ — "
                 "skipped (convert or add it via SceneBuilder.add_mesh)")
        return None
    from .obj import load_obj

    try:
        return load_obj(path)
    except (OSError, ValueError) as e:
        log.warn(f"unity import: failed to load mesh {path!r}: {e}")
        return None


def _material_from(fields) -> Material:
    """RayTraceObject serialized material; absent fields use the C# defaults
    (RayTraceObject.cs:12-15) — SampleScene's older serialization has none."""
    d = Material()
    return Material(
        albedo=_color(fields.get("albedoColor"), d.albedo),
        specular=_color(fields.get("specularColor"), d.specular),
        emission=_color(fields.get("emissionColor"), d.emission),
        smoothness=float(fields.get("smoothness", d.smoothness)),
    )


def load_unity_scene(path: str, aspect: float = 16 / 9,
                     skybox: Optional[np.ndarray] = None,
                     mesh_detail_kw: Optional[dict] = None,
                     include_disabled: bool = False):
    """Load a ``.unity`` scene built on the reference's component model.

    Returns ``(scene, camera, settings)``: the built Scene (objects with an
    enabled RayTraceObject on an active GameObject, reference typing rules),
    a Camera from the scene's camera object at ``aspect``, and a settings
    dict (``numBounces``/``numRays``/``skybox_guid`` when a RayTraceMaster
    is present). Non-builtin mesh references resolve through the project's
    ``.meta`` guid index (OBJ assets load directly, matching the
    reference's ability to flatten any registered sharedMesh —
    RayTraceMaster.cs:298-305); unresolvable guids or unsupported asset
    types are skipped with a warning.

    ``include_disabled`` also loads objects whose RayTraceObject component
    is disabled. Default False matches the reference's RUNTIME: OnEnable
    never fires for a disabled Behaviour, so it never registers
    (RayTraceObject.cs:42). Notably Scene1.unity ships with its two mirror
    quads, the emissive sphere, and one plain sphere DISABLED — the scene
    the reference actually renders is 6 spheres + 4 meshes, while the full
    14-object inventory (what models/fixtures.scene1 transcribes, and what
    SURVEY.md §2.3 counts) needs ``include_disabled=True``.
    """
    with open(path, "r", errors="replace") as f:
        docs = _parse_docs(f.read())

    # Index components by owning GameObject.
    comps = {}
    transforms = {}
    for fid, (cls, cname, fields) in docs.items():
        go = _fid(fields.get("m_GameObject", {}))
        if go:
            comps.setdefault(go, []).append((fid, cls, cname, fields))
        if cname == "Transform":
            transforms[go] = fid

    cache = {}
    b = SceneBuilder()
    log = get_logger()
    cam = None
    settings = {}
    guid_idx = None  # lazy guid -> asset map for non-builtin meshes
    for go_fid, (cls, cname, go) in docs.items():
        if cname != "GameObject":
            continue
        clist = comps.get(go_fid, [])

        def find(name):
            return [f for _fid2, _c, n, f in clist if n == name]

        monos = find("MonoBehaviour")
        camera_fields = find("Camera")
        if camera_fields:
            tfid = transforms.get(go_fid)
            m = _world_matrix(tfid, docs, cache) if tfid else np.eye(4)
            fov = float(camera_fields[0].get("field of view", 60.0))
            fwd = m[:3, :3] @ np.array([0.0, 0.0, 1.0])
            cam = Camera.create(position=tuple(m[:3, 3]), forward=tuple(fwd),
                                fov_y_deg=fov, aspect=aspect)
            for mb in monos:
                if _is_script(mb, RAYTRACE_MASTER_GUID) \
                        or "numBounces" in mb:
                    settings = {
                        "numBounces": int(mb.get("numBounces", 2)),
                        "numRays": int(mb.get("numRays", 1)),
                        "skybox_guid": (mb.get("SkyboxTexture") or {}).get(
                            "guid"),
                    }
            continue

        if int(go.get("m_IsActive", 1)) == 0:
            continue
        rto = None
        for mb in monos:
            if _is_script(mb, RAYTRACE_OBJECT_GUID) or "albedoColor" in mb:
                rto = mb
                break
        if rto is None:
            continue
        if int(rto.get("m_Enabled", 1)) == 0 and not include_disabled:
            continue
        mat = _material_from(rto)
        tfid = transforms.get(go_fid)
        m = _world_matrix(tfid, docs, cache) if tfid else np.eye(4)

        spheres = [f for f in find("SphereCollider")
                   if int(f.get("m_Enabled", 1)) != 0]
        if spheres:
            sc = spheres[0]
            r = float(sc.get("m_Radius", 0.5))
            lossy = np.linalg.norm(m[:3, :3], axis=0)   # per-axis scale
            center = m @ np.append(np.array(_v3(sc.get("m_Center"))), 1.0)
            b.add_sphere(tuple(center[:3]), r * float(lossy.max()), mat)
            continue

        mfs = find("MeshFilter")
        if not mfs:
            continue
        mesh_ref = mfs[0].get("m_Mesh", {})
        kind = _BUILTIN_MESH.get(_fid(mesh_ref))
        if kind is not None:
            v, f, n = _MESH_GEN[kind](**(mesh_detail_kw or {}).get(kind, {}))
        else:
            # Non-builtin mesh: resolve the asset guid through the
            # project's .meta files (index built lazily, once per import).
            guid = (mesh_ref or {}).get("guid") \
                if isinstance(mesh_ref, dict) else None
            loaded = None
            if guid:
                if guid_idx is None:
                    guid_idx = _guid_index(_project_root(path))
                loaded = _resolve_mesh_guid(guid, guid_idx, log)
            if loaded is None:
                log.warn(f"unity import: GameObject {go.get('m_Name')!r} "
                         "uses an unresolvable mesh — skipped (import the "
                         "mesh via models.obj and add it explicitly)")
                continue
            v, f, n = loaded
        b.add_mesh(v, f, transform=m.astype(np.float32), material=mat,
                   normals=n)

    b.set_skybox(skybox if skybox is not None else sun_sky())
    if cam is None:
        cam = Camera.create(position=(0, 1, -10), forward=(0, 0, 1),
                            fov_y_deg=60.0, aspect=aspect)
    return b.build(), cam, settings
