"""The benchmark's machinery: cells and their files found by name
(``cell``), the web-UI clients' process (``clients``), the profiler's
reduction (``trace``) and the comparison that decides ``correct``
(``check``). The traffic drivers are ``traffic/<kind>.py``."""
