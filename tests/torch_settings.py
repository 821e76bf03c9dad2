"""The settings contract between the port and the JAX package, for the
tests that hold one against the other: the port's RenderSettings has the
JAX package's fields and defaults, less JAX_ONLY. It imports no jax."""
import dataclasses

# the JAX package's RenderSettings fields that the port leaves out: the
# bench's stage-duplication hook (the port prices a stage by its stage
# marks) and the sort permute (the port keeps one pool layout)
JAX_ONLY = ("dup_stage", "regen_permute")


def port_fields(settings):
    """{field: value} of a RenderSettings of either package over the port's
    fields."""
    return {k: v for k, v in dataclasses.asdict(settings).items()
            if k not in JAX_ONLY}
