"""Import guard: the port and chip_smoke.py import no package that the
GPU machine lacks. A subprocess refuses jax, flax, optax, orbax, grain,
networkx, cv2, PIL, click, torchvision, matplotlib and the JAX package
itself at import time, then imports every module of cvpce_tpu_torch (the modules listed
in REQUIRED among them) and chip_smoke (without running it)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "grain", "networkx",
          "cv2", "PIL", "click", "torchvision", "matplotlib", "cvpce_tpu"}
REQUIRED = {"cvpce_tpu_torch.ops.metrics", "cvpce_tpu_torch.eval",
            "cvpce_tpu_torch.eval.coco_protocol",
            "cvpce_tpu_torch.eval.proposals",
            "cvpce_tpu_torch.eval.detection",
            "cvpce_tpu_torch.eval.classification",
            "cvpce_tpu_torch.eval.compliance",
            "cvpce_tpu_torch.pipeline.calibrate",
            "cvpce_tpu_torch.pipeline.serving",
            "cvpce_tpu_torch.pipeline.colorcorrect",
            "cvpce_tpu_torch.pipeline.native",
            "cvpce_tpu_torch.cli", "cvpce_tpu_torch.cli.common",
            "cvpce_tpu_torch.cli.gln", "cvpce_tpu_torch.cli.eval",
            "cvpce_tpu_torch.cli.misc", "cvpce_tpu_torch.cli.dihe",
            "cvpce_tpu_torch.cli.datasets",
            "cvpce_tpu_torch.utils.torch_import",
            "cvpce_tpu_torch.ops.matching", "cvpce_tpu_torch.ops.losses",
            "cvpce_tpu_torch.ops.gaussians", "cvpce_tpu_torch.data.loader",
            "cvpce_tpu_torch.data.sku110k", "cvpce_tpu_torch.train",
            "cvpce_tpu_torch.train.gln", "cvpce_tpu_torch.train.checkpoint",
            "cvpce_tpu_torch.train.loops", "cvpce_tpu_torch.models.gan",
            "cvpce_tpu_torch.train.dihe", "cvpce_tpu_torch.train.hyperopt",
            "cvpce_tpu_torch.parallel", "cvpce_tpu_torch.parallel.mesh",
            "cvpce_tpu_torch.parallel.multihost",
            "cvpce_tpu_torch.ops.knn_sharded",
            "cvpce_tpu_torch.parallel.spatial",
            "cvpce_tpu_torch.utils.profiling",
            "cvpce_tpu_torch.data.png", "cvpce_tpu_torch.data.jpeg",
            "cvpce_tpu_torch.utils.viz", "cvpce_tpu_torch.data.defaults",
            "cvpce_tpu_torch.data.grocery",
            "cvpce_tpu_torch.data.planograms",
            "cvpce_tpu_torch.data.grozi", "cvpce_tpu_torch.data.coco",
            "cvpce_tpu_torch.data.cache",
            "cvpce_tpu_torch.data.grain_loader"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import cvpce_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    cvpce_tpu_torch.__path__, "cvpce_tpu_torch.")]
assert REQUIRED <= set(names), sorted(REQUIRED - set(names))
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print("imported", len(names) + 2)
"""


def test_port_imports_no_missing_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[-1])
    assert count >= 46
