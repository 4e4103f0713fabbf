"""HTML result gallery.

The counterpart of the JAX package's `testset/report.py` (reference:
test/generate_results_webpage.py, a Jinja2 gallery of the inputs, the
reconstruction and the edits of each sample), with the recon PSNR and SSIM
the reference lacks, and the per-step denoising page.
"""

from __future__ import annotations

import json
import pathlib
from collections import OrderedDict

import numpy as np

from diffusionhandles_tpu_torch.testset.metrics import ssim
from diffusionhandles_tpu_torch.utils.image_io import load_image

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<title>{{ title }}</title>
<style>
body { font-family: sans-serif; background: #f5f5f5; }
table { border-collapse: collapse; background: white; }
td, th { border: 1px solid #ccc; padding: 6px; text-align: center;
         vertical-align: top; }
img { max-width: 192px; display: block; }
.caption { font-size: 11px; color: #555; }
</style>
</head>
<body>
<h1>{{ title }}</h1>
<table>
<tr><th>sample</th><th>input</th><th>mask</th><th>disparity</th>
<th>recon</th><th>edits</th></tr>
{% for sample in samples %}
<tr>
<td>{{ sample.name }}{% if sample.psnr is not none %}
  <div class="caption">recon PSNR: {{ "%.2f" | format(sample.psnr) }} dB{% if sample.ssim is not none %} / SSIM {{ "%.3f" | format(sample.ssim) }}{% endif %}
  <br>LPIPS: n/a without converted VGG16 weights (models/lpips.py)
  </div>{% endif %}</td>
<td><img src="{{ sample.input }}"></td>
<td><img src="{{ sample.mask }}"></td>
<td><img src="{{ sample.disparity }}"></td>
<td><img src="{{ sample.recon }}"></td>
<td><table><tr>
{% for edit in sample.edits %}
<td><img src="{{ edit.img }}"><div class="caption">{{ edit.name }}</div>
{% if edit.disparity %}<img src="{{ edit.disparity }}">{% endif %}</td>
{% endfor %}
</tr></table></td>
</tr>
{% endfor %}
</table>
</body>
</html>
"""


_STEPS_TEMPLATE = """<!DOCTYPE html>
<html><head><title>{{ title }}</title>
<style>body{font-family:sans-serif}td{padding:4px;text-align:center}
img{max-width:128px;display:block}</style></head>
<body><h1>{{ title }}</h1><table>
<tr><th>step</th><th>post-opt</th><th>post-denoise</th></tr>
{% for s in steps %}
<tr><td>{{ s.idx }}</td><td><img src="{{ s.opt }}"></td>
<td><img src="{{ s.den }}"></td></tr>
{% endfor %}
</table></body></html>
"""


def generate_denoising_steps_webpage(steps_dir, website_path) -> None:
    """Per-step denoising gallery (reference:
    test/webpage_templates/denoising_steps_template.html)."""
    import jinja2
    steps_dir = pathlib.Path(steps_dir)
    opt_files = sorted(steps_dir.glob("step_*_opt.png"))
    steps = []
    for f in opt_files:
        idx = f.stem.split("_")[1]
        steps.append({"idx": idx,
                      "opt": f"{steps_dir.name}/{f.name}",
                      "den": f"{steps_dir.name}/step_{idx}_denoise.png"})
    html = jinja2.Template(_STEPS_TEMPLATE).render(
        title=f"Denoising steps: {steps_dir.name}", steps=steps)
    pathlib.Path(website_path).write_text(html)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(1.0 / mse)


def generate_results_webpage(test_set_path: str, website_path: str,
                             relative_image_dir: str = ".",
                             show_denoising_steps: bool = False,
                             num_timesteps: int = 50,
                             num_optsteps: int = 3) -> None:
    """Build the summary gallery
    (reference: generate_results_webpage.py:9-77)."""
    import jinja2

    test_set_path = pathlib.Path(test_set_path)
    website_path = pathlib.Path(website_path)
    out_dir = website_path.parent
    with open(test_set_path) as f:
        dataset_names = json.load(f, object_pairs_hook=OrderedDict)

    samples = []
    for sample_name, transform_names in dataset_names.items():
        sdir = out_dir / sample_name
        rel = f"{relative_image_dir}/{sample_name}"
        sample_psnr = None
        sample_ssim = None
        if (sdir / "input.png").exists() and (sdir / "recon.png").exists():
            inp = load_image(sdir / "input.png")
            rec = load_image(sdir / "recon.png")
            sample_psnr = psnr(inp, rec)
            sample_ssim = float(ssim(inp, rec))
        edits = []
        for t in transform_names:
            if (sdir / f"{t}.png").exists():
                disp = (f"{rel}/{t}_disparity.png"
                        if (sdir / f"{t}_disparity.png").exists() else None)
                edits.append({"name": t, "img": f"{rel}/{t}.png",
                              "disparity": disp})
        samples.append({
            "name": sample_name,
            "input": f"{rel}/input.png",
            "mask": f"{rel}/mask.png",
            "disparity": f"{rel}/disparity.png",
            "recon": f"{rel}/recon.png",
            "edits": edits,
            "psnr": sample_psnr,
            "ssim": sample_ssim,
        })

    html = jinja2.Template(_TEMPLATE).render(
        title=f"DiffusionHandles-TPU results: {test_set_path.stem}",
        samples=samples)
    website_path.write_text(html)
