"""The PyTorch port imports without JAX and without the JAX package."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_with_jax_blocked():
    """Every module of isogs_slam_tpu_torch imports with `jax` blocked, and
    none of them pulls in anything of isogs_slam_tpu."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import isogs_slam_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "isogs_slam_tpu" or m.startswith("isogs_slam_tpu.")
               or m == "jax" and sys.modules[m] is not None]
        assert not bad, bad
        assert "isogs_slam_tpu_torch.slam.icp" in names
        assert "isogs_slam_tpu_torch.mesh.density" in names
        assert "isogs_slam_tpu_torch.native_ext" in names
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 67


def test_port_imports_without_image_and_plot_libraries():
    """Every module of the port, the dataset registry and the eval helpers
    among them, imports on a machine without imageio, PIL, cv2, matplotlib
    and yaml; the synthetic dataset is constructed there too."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "imageio", "PIL", "cv2", "matplotlib", "yaml"):
            sys.modules[name] = None
        import isogs_slam_tpu_torch as pkg
        import isogs_slam_tpu_torch.datasets as D
        import isogs_slam_tpu_torch.eval.eval_helpers
        import isogs_slam_tpu_torch.eval.online
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        ds = D.get_dataset({"dataset_name": "synthetic"}, "", "s",
                           device="cpu", desired_height=32, desired_width=48,
                           num_frames=2)
        assert len(ds) == 2 and ds.png_depth_scale == 6553.5
        # every file loader is registered and reaches its own config or
        # metadata parsing (an empty camera block, or no files at all)
        for name in ("replica", "replicav2", "tum", "icl", "scannet",
                     "azure", "record3d", "realsense", "ai2thor"):
            try:
                D.get_dataset({"dataset_name": name, "camera_params": {}},
                              "/nonexistent", "s")
            except KeyError:
                pass
            except ValueError as e:      # icl: no *.gt.sim pose file
                assert name == "icl" and "gt.sim" in str(e), (name, e)
            else:
                raise AssertionError(name)
        for name in ("nerfcapture", "scannetpp"):
            try:
                D.get_dataset({"dataset_name": name}, "/nonexistent", "s")
            except FileNotFoundError:
                pass
            else:
                raise AssertionError(name)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_import():
    """No source line of the port imports jax or the JAX package."""
    pkg = os.path.join(ROOT, "isogs_slam_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if (s.startswith(("import ", "from "))
                            and (" jax" in s or "isogs_slam_tpu " in s
                                 or "isogs_slam_tpu." in s)):
                        offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
