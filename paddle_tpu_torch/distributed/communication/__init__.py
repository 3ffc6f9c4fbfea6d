from .group import (Group, ReduceOp, axis_group,  # noqa: F401
                    get_world_group, new_group)
