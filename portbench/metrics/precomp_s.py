"""precomp_s: ``make_collision_operator`` (the operator's host tables and
their upload), host clock to a synchronise."""


def read(run):
    return run.precomp_s
