"""Workload generation (reference: src/datagen/)."""

from .c_rng import RAND_MAX, GlibcRand  # noqa: F401
from .generator import (  # noqa: F401
    append_rows,
    create_relation_fk,
    create_relation_fk_from_pk,
    create_relation_nonunique,
    create_relation_pk,
    create_relation_zipf,
    parallel_create_relation,
    read_relation,
    seed_generator,
    write_relation,
)
