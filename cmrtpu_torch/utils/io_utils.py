"""Filesystem + logging utilities (ref: src/utils/Utils_io.py).

``console_and_file_logger`` reproduces the reference's logging layout: INFO to
console, ERROR duplicated into a dedicated ``<name>_errors.log`` file
(ref: src/utils/Utils_io.py:44-98). ``ensure_dir`` is EEXIST-safe for parallel
workers (ref: src/utils/Utils_io.py:101-116). The port's own copy of
``cmrtpu/utils/io_utils.py``; its device listing names the CUDA cards.
"""

from __future__ import annotations

import errno
import logging
import os


def ensure_dir(file_path: str) -> None:
    if not file_path or os.path.exists(file_path):
        return
    try:  # parallel-worker safe
        os.makedirs(file_path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


def console_and_file_logger(logfile_name: str = "Log", log_lvl: int = logging.INFO,
                            path: str = "./logs/") -> logging.Logger:
    """Root logger: console at ``log_lvl``, errors into ``<name>_errors.log``."""
    formatter = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)

    log_f_error = os.path.join(path, logfile_name + "_errors.log")
    ensure_dir(os.path.dirname(os.path.abspath(log_f_error)))

    logger.handlers = []
    hdlr_console = logging.StreamHandler()
    hdlr_console.setFormatter(formatter)
    hdlr_console.setLevel(log_lvl)
    hdlr_error = logging.FileHandler(log_f_error)
    hdlr_error.setFormatter(formatter)
    hdlr_error.setLevel(logging.ERROR)
    logger.addHandler(hdlr_console)
    logger.addHandler(hdlr_error)

    logging.info("%s Start %s", "--" * 10, "--" * 10)
    logging.info("Working directory: %s", os.getcwd())
    logging.info("Error log file: %s", log_f_error)
    return logger


# Backwards-friendly alias matching the reference class name.
Console_and_file_logger = console_and_file_logger


def save_plot(fig, path: str, filename: str = "plot.png",
              override: bool = False, tight: bool = True) -> str:
    """Save a matplotlib figure, auto-suffixing instead of overwriting
    (ref: save_plot, src/utils/Utils_io.py:118-148)."""
    ensure_dir(path)
    if tight:
        fig.tight_layout()
    target = os.path.join(path, filename)
    if not override:
        stem, ext = os.path.splitext(filename)
        version = 0
        while os.path.exists(target):
            version += 1
            target = os.path.join(path, f"{stem}_{version}{ext}")
    fig.savefig(target)
    return target


def get_metadata_maybe(img, key: str, default: str = "not_found"):
    """Unicode-safe metadata lookup on a MedicalImage (ref: get_metadata_maybe,
    src/utils/Utils_io.py:150-161)."""
    value = getattr(img, "metadata", {}).get(key, default)
    if not isinstance(value, (int, float)):
        value = str(value).encode("utf8", "backslashreplace").decode(
            "utf-8").replace("\\udcfc", "ue")
    return value



def show_available_devices():
    """Accelerator inventory, the stand-in for the reference's GPU chooser
    (ref: src/utils/Tensorflow_helper.py:4-74): one line per CUDA device in
    the form of cmrtpu's, with the bytes in use out of the card's total
    (``torch.cuda.mem_get_info``), or one line saying that there is none.
    Returns the devices (``torch.device``), the CPU alone without a
    card."""
    import torch

    if not torch.cuda.is_available():
        logging.info("device cpu: no CUDA device, running on the CPU")
        return [torch.device("cpu")]
    devices = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        logging.info("device %s: %s, hbm %s/%s", i,
                     torch.cuda.get_device_name(i), total - free, total)
        devices.append(torch.device("cuda", i))
    return devices
