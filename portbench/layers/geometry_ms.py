"""`geometry_ms.<suffix>`: device ms per clip inside the camera solve's and
the stitch's spans (`camray_windows_to_cameras`, `stitch_dense_outputs`)."""

from portbench.layers._stage import per_unit_ms


def read(metric, run):
    if not run.spans.calls.get("stitch_dense_outputs"):
        return None
    names = ("stitch_dense_outputs",) + (("camray_windows_to_cameras",)
                                         if run.spans.calls.get("camray_windows_to_cameras") else ())
    return per_unit_ms(run, names)
