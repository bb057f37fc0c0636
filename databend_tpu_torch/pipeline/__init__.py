from .executor import execute_plan, execute_plan_blocks

__all__ = ["execute_plan", "execute_plan_blocks"]
