"""Launch tooling of the port: the production layouts (``mesh``), the H^2
dry run at the paper's per-device load (``dryrun_h2``), the LM inputs and
caches on ``meta`` (``shapes``), the LM dry run (``dryrun``), the LM server
(``serve``) and the training loop (``train``).  Importing a module here
touches no device."""
