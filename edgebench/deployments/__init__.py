"""Deployment kinds, one file each, named by a configuration's
``deployment`` key: ``<kind>.py`` defines ``deploy(config, net, device)``,
which returns a ``deploy.Deployment`` (or a subclass of it that holds the
kind's entry points). Every file here is imported in every run, so a
kind imports the program inside its ``deploy``, not at the top."""
