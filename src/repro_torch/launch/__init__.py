"""Launch tooling of the port: the production layouts (``mesh``), the H^2
dry run at the paper's per-device load (``dryrun_h2``) and the LM server
(``serve``).  Importing a module here touches no device."""
