"""Main application entry of the port: the web UI, the REST API, health
and metrics on one port.

Counterpart of video_enhancer_tpu/app.py, plus ``--device``:
``python -m video_enhancer_tpu_torch.app`` serves the UI at ``/ui``, the
API at ``/api/v1/*``, ``/health`` and ``/metrics`` on port 7860, its jobs
on the card unless ``--device cpu`` (or ``$VETPU_PLATFORM=cpu``) asks for
the CPU; without a card it does not start. ``--self-test`` warms
cnn_upscaler and bicubic on a 32x32 clip of 2 frames before serving, as the
JAX package does.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    p = argparse.ArgumentParser(prog="video_enhancer_tpu_torch.app")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--require-auth", action="store_true")
    p.add_argument("--self-test", action="store_true",
                   help="run a functionality self-test at startup "
                        "(reference initialize_enhancer, app.py:626-751)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .utils.logging_config import setup_logging

    setup_logging(structured=False)
    log = logging.getLogger("app")

    from .serving.app import ApiServer, create_app
    from .serving.http import serve
    from .serving.ui import register_ui

    server = ApiServer(data_dir=args.data_dir,
                       require_auth=args.require_auth, device=args.device)
    router = create_app(server)
    register_ui(router)
    if args.self_test:
        from .warm_start import warm_start

        results = warm_start(models=["cnn_upscaler", "bicubic"], size=32,
                             frames=2, device=server.device)
        ok = all(r["ok"] for r in results.values())
        log.info("self-test %s: %s", "passed" if ok else "FAILED", results)
    log.info("UI on http://%s:%d/ui  API on /api/v1 (%s)", args.host,
             args.port, server.device)
    serve(router, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
