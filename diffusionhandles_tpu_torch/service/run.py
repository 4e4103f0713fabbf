"""Service launcher: `python -m diffusionhandles_tpu_torch.service.run
<name>`.

Names: pipeline, diffhandles, depth, remover, selector, text2img, on ports
8888-8893 (reference: start_webapps_in_tmux.sh:21-43), the JAX package's
launcher's names, ports and checkpoint flags. The services serve on the
GPU. The pipeline service finds the others at DIFFHANDLES_{CORE, DEPTH,
REMOVER, SELECTOR, TEXT2IMG}_URL (deploy/k8s sets these to its Service
names), else on the local ports. Under the env contract of
`parallel/distributed.py` (DIFFHANDLES_COORDINATOR, _NUM_PROCESSES,
_PROCESS_ID) the process first joins the launcher's process group on its
GPU.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_PORTS = {"pipeline": 8888, "diffhandles": 8889, "depth": 8890,
                 "remover": 8891, "selector": 8892, "text2img": 8893}
UPSTREAM_URLS = (("diffhandles_url", "DIFFHANDLES_CORE_URL"),
                 ("depth_url", "DIFFHANDLES_DEPTH_URL"),
                 ("remover_url", "DIFFHANDLES_REMOVER_URL"),
                 ("selector_url", "DIFFHANDLES_SELECTOR_URL"),
                 ("text2img_url", "DIFFHANDLES_TEXT2IMG_URL"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("service", choices=list(DEFAULT_PORTS))
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--variant", default="sd2", choices=["sd2", "tiny"])
    parser.add_argument("--netpath", default="")
    # released checkpoint files (see PARITY.md): each service loads real
    # weights when its path is given, seeded-random otherwise
    parser.add_argument("--zoedepth_checkpoint", default=None)
    parser.add_argument("--lama_checkpoint", default=None)
    parser.add_argument("--sam_checkpoint", default=None)
    parser.add_argument("--gdino_checkpoint", default=None)
    parser.add_argument("--bert_vocab", default=None)
    args = parser.parse_args(argv)

    # Multi-host placement: join the launcher's process group when it set
    # the env contract (parallel/distributed.py), before any model loads.
    from diffusionhandles_tpu_torch.parallel.distributed import \
        maybe_init_from_env
    dist = maybe_init_from_env()
    if dist is not None:
        print(f"joined distributed runtime: process "
              f"{dist['process_id']}/{dist['num_processes']}, "
              f"{dist['local_devices']} local / {dist['global_devices']} "
              f"global devices", flush=True)

    from diffusionhandles_tpu_torch.service import pipeline_app, services
    port = args.port or DEFAULT_PORTS[args.service]

    if args.service == "diffhandles":
        app = services.DiffhandlesWebapp(port=port, variant=args.variant,
                                         netpath=args.netpath)
    elif args.service == "pipeline":
        urls = {key: os.environ[env] for key, env in UPSTREAM_URLS
                if os.environ.get(env)}
        pipeline = pipeline_app.DiffhandlesPipeline(**urls) if urls else None
        app = pipeline_app.DiffhandlesPipelineWebapp(pipeline=pipeline,
                                                     port=port,
                                                     netpath=args.netpath)
    elif args.service == "depth":
        estimator = None
        if args.zoedepth_checkpoint:
            from diffusionhandles_tpu_torch.models.zoedepth import \
                ZoeDepthEstimator
            estimator = ZoeDepthEstimator(
                checkpoint_path=args.zoedepth_checkpoint)
        elif args.variant == "tiny":
            from diffusionhandles_tpu_torch.models.zoedepth import (
                ZoeDepthEstimator, tiny_zoedepth_config)
            estimator = ZoeDepthEstimator(tiny_zoedepth_config())
        app = services.DepthEstimatorWebapp(estimator=estimator, port=port,
                                            netpath=args.netpath)
    elif args.service == "remover":
        remover = None
        if args.lama_checkpoint:
            from diffusionhandles_tpu_torch.models.lama import LamaInpainter
            remover = LamaInpainter(checkpoint_path=args.lama_checkpoint)
        app = services.ForegroundRemoverWebapp(remover=remover, port=port,
                                               netpath=args.netpath)
    elif args.service == "selector":
        selector = None
        if args.sam_checkpoint or args.gdino_checkpoint:
            from diffusionhandles_tpu_torch.models.segmenter import \
                LangSamSegmenter
            selector = LangSamSegmenter(
                sam_checkpoint=args.sam_checkpoint,
                gdino_checkpoint=args.gdino_checkpoint,
                bert_vocab_path=args.bert_vocab)
        app = services.ForegroundSelectorWebapp(selector=selector,
                                                port=port,
                                                netpath=args.netpath)
    else:
        app = services.Text2ImgWebapp(port=port, variant=args.variant,
                                      netpath=args.netpath)
    print(f"serving {args.service} on :{port}", flush=True)
    app.run()


if __name__ == "__main__":
    main()
