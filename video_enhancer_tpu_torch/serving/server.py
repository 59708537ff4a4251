"""Server entry point: ``python -m video_enhancer_tpu_torch.serving.server``.

Counterpart of video_enhancer_tpu/serving/server.py, plus ``--device``: the
jobs run on the card unless ``cpu`` is given (without a card the server
does not start).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--require-auth", action="store_true")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .app import ApiServer, create_app
    from .http import serve

    server = ApiServer(data_dir=args.data_dir,
                       require_auth=args.require_auth,
                       worker_threads=args.workers, device=args.device)
    router = create_app(server)
    print(f"video-enhancer-tpu API on {args.host}:{args.port} "
          f"({server.device})")
    serve(router, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
