"""veneur_tpu_torch: the aggregation server binary of the PyTorch port.

    python -m veneur_tpu_torch.cli.veneur_main -f cfg.yaml [--device cpu]

Runs on the card unless ``--device`` names another device. Config keys
the port does not support yet are refused by name (core/factory.py).
The startup line lists every listener with its bound port: the statsd
ones (udp://, tcp://, unixgram://) and the SSF ones
(``ssf_listen_addresses``; an SSF spec equal to a statsd one is keyed
``ssf:<spec>``). SIGTERM/SIGINT stop the server after one final flush.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.core.config import load_config
from veneur_tpu_torch.core.factory import UnportedConfigError, build_server


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="veneur-tpu-torch")
    parser.add_argument("-f", dest="config", required=True,
                        help="path to config yaml")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("-validate-config", action="store_true",
                        dest="validate")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("veneur_tpu_torch")
    try:
        cfg = load_config(args.config)
        if args.validate:
            from veneur_tpu_torch.core.factory import check_config

            check_config(cfg)
            print("config valid")
            return 0
        server = build_server(cfg, device=args.device)
    except (UnportedConfigError, ValueError, OSError) as e:
        print(f"config invalid: {e}", file=sys.stderr)
        return 1
    except RuntimeError as e:  # the asked-for device is not available
        print(f"device unavailable: {e}", file=sys.stderr)
        return 1
    if cfg.debug:
        logging.getLogger().setLevel(logging.DEBUG)

    ports = server.start()
    log.info("veneur-tpu-torch %s serving on %s (local=%s) listeners=%s",
             server.version, server.device, server.is_local, ports)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.is_set():
        stop.wait(0.5)
    # graceful drain: final-epoch flush, then bounded spill settling
    # with honest shutdown.* counters for whatever the deadline clips
    try:
        log.info("graceful drain: %s", server.graceful_drain())
    except Exception:
        log.exception("graceful drain failed")
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
