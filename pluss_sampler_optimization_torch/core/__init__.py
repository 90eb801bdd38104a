from .schedule import StaticSchedule
from .trace import NestTrace, ProgramTrace

__all__ = ["StaticSchedule", "NestTrace", "ProgramTrace"]
