"""The port's first pass over archive TOD, on the band's input map, held to
run()'s own pass given that map: the chain of
tests/test_torch_archive_run.py (nside 16 / lmax 32, band 030 from
archives with the sidelobe and zodi terms and per-detector bandpasses,
bands 044 and 070 at map level, one iteration, run()'s draws replayed)
with the port in its default form (loop._REFERENCE_FORM off) and run()'s
_init_band_maps_from_tod running its process_tod on sys.data's rows of the
band in place of the zero sky. The archives' orbital dipole is the
simulated one: the pass on the input map needs no stronger one (ROADMAP
queue 3 item 25). Held to the same bounds."""
from test_torch_archive_run import _runs, hold


def test_run_from_archives_on_the_input_maps_matches_run(tmp_path):
    hold(tmp_path, *_runs(tmp_path, dipole=1.0, reference=False))
