from .serial import OracleResult, run_serial
from .numpy_ref import run_numpy

__all__ = ["OracleResult", "run_serial", "run_numpy"]
