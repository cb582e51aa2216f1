"""build_s (build layer): the program's matrix build and weighting, on
the host clock around the builder, ended by a synchronise."""


def read(rec):
    return rec.get("build_s")
