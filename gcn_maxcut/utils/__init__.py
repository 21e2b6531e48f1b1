from gcn_maxcut.utils.cache import enable_compilation_cache
from gcn_maxcut.utils.logging import get_logger
from gcn_maxcut.utils.timing import Timer, PhaseTimer

__all__ = ["enable_compilation_cache", "get_logger", "Timer", "PhaseTimer"]
