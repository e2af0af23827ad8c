"""Name parity of the port with the JAX package, by an AST walk (no import):
every module of isogs_slam_tpu/ has a module at the same relative path in
isogs_slam_tpu_torch/, binding every public name the JAX module defines
(top-level def, class, class method, module-level constant or alias), and
every user-facing shell driver of the JAX package has its port counterpart
at the mirrored path under isogs_slam_tpu_torch/. What the port leaves out
on purpose stands in the exception dicts below, each with its reason."""
import ast
import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "isogs_slam_tpu")
PORT_PKG = os.path.join(ROOT, "isogs_slam_tpu_torch")

# JAX modules without a port module, and public names a port module does
# not bind (class methods as "Class.method"), each with the reason
EXCEPTIONS = {
    "ops/gather.py": "works around TPU gather/scatter layout costs; the "
                     "port gathers rows by plain indexing",
    "ops/reference_renderer.py": "the JAX package's own test oracle; the "
                                 "port is held to it through the JAX "
                                 "rasterizer in the tests",
    "ops/pallas_composite.py": "the Pallas kernels A and B, replaced by "
                               "ops/composite.py + csrc/composite.cu",
    "eval/lpips_jax.py": "replaced by eval/lpips.py",
    "utils/common.py::acquire_tpu_lock": "a flock serialising TPU processes "
                                         "on one host",
    "utils/common.py::enable_compilation_cache": "XLA's persistent compile "
                                                 "cache",
    "ops/segreduce.py::GB": "the TPU kernel's lane layout",
    "ops/segreduce.py::LANES": "the TPU kernel's lane layout",
    "ops/segreduce.py::W": "the TPU kernel's lane layout",
    "ops/rasterize.py::RasterConfig.backend": "the port's backend is the "
                                              "tensor's device",
    "ops/rasterize.py::RasterConfig.resolve_backend": "the port's backend "
                                                      "is the tensor's "
                                                      "device",
}

# the JAX package's shell drivers the port has no counterpart of, with the
# reason
DRIVER_EXCEPTIONS = {
    **{os.path.relpath(p, ROOT): "a TPU measurement chain of the JAX "
                                 "package's own rounds"
       for p in sorted(glob.glob(os.path.join(ROOT, "bash_scripts",
                                              "tpu_*.sh")))},
    "bash_scripts/wait_then_r4s2.sh": "a TPU measurement chain of the JAX "
                                      "package's own rounds",
    **{os.path.relpath(p, ROOT): "names no package: serves both as it is"
       for p in sorted(glob.glob(os.path.join(ROOT, "bash_scripts",
                                              "download_*.sh")))},
}

JAX_MODULES = sorted(os.path.relpath(p, JAX_PKG) for p in glob.glob(
    os.path.join(JAX_PKG, "**", "*.py"), recursive=True))
JAX_DRIVERS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ("bash_scripts/*.sh", "bash_scripts/*.bash",
                    "configs/*/*.bash")
    for p in glob.glob(os.path.join(ROOT, pattern)))
PORT_DRIVERS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ("**/*.sh", "**/*.bash")
    for p in glob.glob(os.path.join(PORT_PKG, pattern), recursive=True))
MODULE_RE = re.compile(r"\b(isogs_slam_tpu(?:_torch)?)((?:\.\w+)+)")


def _statements(body):
    """A body's statements, with those inside module-level if / try blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            for b in (node.body, node.orelse, node.finalbody,
                      *(h.body for h in node.handlers)):
                yield from _statements(b)
        else:
            yield node


def _bound(node):
    """Names a statement binds: def, class, assignment or import."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [n.id for t in node.targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    return []


def _bindings(path):
    """{name bound at module level: set of names bound in its class body}."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in _statements(tree.body):
        for name in _bound(node):
            out.setdefault(name, set())
        if isinstance(node, ast.ClassDef):
            out[node.name] |= {n for m in _statements(node.body)
                               for n in _bound(m)}
    return out


def _public(path):
    """The JAX module's public names: top-level defs, classes, constants
    and aliases (assignments), and "Class.method" for each public method of
    a public class."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in _statements(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        names += [n for n in _bound(node) if not n.startswith("_")]
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names += [f"{node.name}.{m.name}"
                      for m in _statements(node.body)
                      if isinstance(m, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and not m.name.startswith("_")]
    return names


def _missing(rel):
    port = _bindings(os.path.join(PORT_PKG, rel))
    out = []
    for name in _public(os.path.join(JAX_PKG, rel)):
        cls, _, method = name.partition(".")
        if cls not in port or (method and method not in port[cls]):
            out.append(name)
    return out


def test_every_jax_module_is_a_case():
    """The walk finds the JAX package's modules (120 at the time of
    writing; a new one becomes a case of its own)."""
    assert len(JAX_MODULES) >= 120
    assert "slam/keyframes.py" in JAX_MODULES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_binds_every_public_name(rel):
    """The port module at the same path binds each public name of the JAX
    module, except the names EXCEPTIONS lists with their reason; each
    exception must still be needed (the name exists in the JAX module and
    the port has no binding of it)."""
    port_path = os.path.join(PORT_PKG, rel)
    if rel in EXCEPTIONS:
        assert not os.path.exists(port_path), (
            f"{rel} is ported now: drop its exception")
        return
    assert os.path.exists(port_path), f"no port module at {rel}"
    excepted = {k.split("::", 1)[1] for k in EXCEPTIONS
                if k.startswith(rel + "::")}
    missing = _missing(rel)
    assert sorted(set(missing) - excepted) == [], (
        f"{rel}: public names without a binding in the port")
    jax_names = _bindings(os.path.join(JAX_PKG, rel))
    port_names = _bindings(port_path)
    for name in excepted:
        cls, _, attr = name.partition(".")
        assert cls in jax_names and (not attr or attr in jax_names[cls]), (
            f"{rel}::{name} is not in the JAX module: drop its exception")
        assert cls not in port_names or (attr and
                                         attr not in port_names[cls]), (
            f"{rel}::{name} is bound in the port now: drop its exception")


def test_exceptions_name_jax_modules():
    """Every exception names a module of the JAX package, and gives a
    reason."""
    for key, reason in EXCEPTIONS.items():
        assert key.split("::")[0] in JAX_MODULES, key
        assert reason.strip(), key
    for key, reason in DRIVER_EXCEPTIONS.items():
        assert key in JAX_DRIVERS and reason.strip(), key


@pytest.mark.parametrize("rel", JAX_DRIVERS)
def test_jax_driver_has_port_counterpart(rel):
    """Every shell driver under bash_scripts/ and configs/*/*.bash that
    names a JAX-package module has its counterpart at the mirrored path
    under isogs_slam_tpu_torch/, naming the port's module of each JAX
    module it names (and maybe more: start_env.bash also builds the
    kernels); the exceptions give their reason (a download script names no
    package)."""
    with open(os.path.join(ROOT, rel)) as f:
        text = f.read()
    jax_modules = {m.group(2) for m in MODULE_RE.finditer(text)
                   if m.group(1) == "isogs_slam_tpu"}
    if rel in DRIVER_EXCEPTIONS:
        if rel.startswith("bash_scripts/download_"):
            assert not jax_modules
        assert not os.path.exists(os.path.join(PORT_PKG, rel))
        return
    assert jax_modules, f"{rel} names no JAX-package module"
    port = os.path.join(PORT_PKG, rel)
    assert os.path.exists(port), f"no port counterpart of {rel}"
    with open(port) as f:
        port_modules = {m.group(2) for m in MODULE_RE.finditer(f.read())
                        if m.group(1) == "isogs_slam_tpu_torch"}
    assert port_modules >= jax_modules


@pytest.mark.parametrize("rel", PORT_DRIVERS)
def test_port_driver_names_only_port_modules(rel):
    """A port driver names no isogs_slam_tpu. module, and each
    isogs_slam_tpu_torch. module it runs exists; it is executable, as the
    originals are."""
    path = os.path.join(ROOT, rel)
    with open(path) as f:
        text = f.read()
    found = list(MODULE_RE.finditer(text))
    assert found and all(m.group(1) == "isogs_slam_tpu_torch"
                         for m in found), rel
    for m in found:
        mod = os.path.join(ROOT, m.group(1), *m.group(2)[1:].split("."))
        assert (os.path.exists(mod + ".py")
                or os.path.isdir(mod)), f"{rel}: {m.group(0)}"
    assert os.access(path, os.X_OK)
