"""Command-line host.

Port of ``spacedrive_tpu/cli.py``: ``serve`` runs a node and its
HTTP/WebSocket API server until interrupted. The node runs its kernels on
the card (``--device cuda``, the default, which fails at once where CUDA
is absent); ``--device cpu`` runs the plain versions. ``header``,
``encrypt`` and ``decrypt`` wait for the port's crypto plane (ROADMAP
queue A item 5); they say so and exit with code 2.

Usage:
    python -m spacedrive_tpu_torch serve --data-dir ~/.spacedrive-tpu [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

CRYPTO_PENDING = ("{cmd}: not available yet; the port's crypto plane "
                  "(ROADMAP queue A item 5) brings it")


def _cmd_serve(args) -> int:
    import asyncio

    from .api.server import serve

    try:
        asyncio.run(serve(args.data_dir, args.host, args.port, device=args.device,
                          discovery=not args.no_discovery))
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_crypto_pending(args) -> int:
    print(CRYPTO_PENDING.format(cmd=args.cmd), file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacedrive_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the node + API server")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the kernels run (default: the card)")
    p.add_argument("--no-discovery", action="store_true",
                   help="start the p2p listener without LAN discovery")
    p.set_defaults(fn=_cmd_serve)

    for cmd, help_ in (("header", "inspect an encrypted file's header"),
                       ("encrypt", "encrypt a file"), ("decrypt", "decrypt a file")):
        p = sub.add_parser(cmd, help=f"{help_} (not available yet)")
        p.add_argument("path")
        p.add_argument("-o", "--output")
        p.add_argument("-p", "--password")
        p.set_defaults(fn=_cmd_crypto_pending)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
