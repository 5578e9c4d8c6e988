"""How a traffic mix's pipeline is built from the program, one file per
``pipeline`` name a traffic file gives: ``build(models, traffic)`` returns
the ``SonarPipeline`` the window calls."""
