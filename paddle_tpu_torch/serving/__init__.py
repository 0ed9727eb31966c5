from .block_pool import BlockPool, BlockPoolExhausted
from .engine import ServingConfig, ServingEngine
from .scheduler import Request, Scheduler

__all__ = ["BlockPool", "BlockPoolExhausted", "Request", "Scheduler",
           "ServingConfig", "ServingEngine"]
