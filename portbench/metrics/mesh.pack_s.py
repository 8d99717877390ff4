"""Mesh engine, host: seconds of the sketches' pack into planes padded to a
multiple of the mesh (the span ``mesh.pack``, ``_pack_rows_for_mesh``);
mean over the window's jobs that opened it."""


def read(run):
    vals = [j["stats"]["spans"]["mesh.pack"]["total_s"] for j in run.jobs
            if "mesh.pack" in j["stats"].get("spans", {})]
    return sum(vals) / len(vals) if vals else None
