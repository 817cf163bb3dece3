"""How each kind of answer is judged, one file each (see ``benchmark.judge``)."""
