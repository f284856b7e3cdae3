"""Config-render parity: ``binder_torch.config.render`` against
``binder_tpu.config.render``.

The shipped deploy template (``deploy/config/template`` through
``deploy/config/manifest.json``) rendered by both packages with Triton
metadata (a ``dns_domain`` key: the branch with the UFDS recursion
block) and with Manta metadata (no ``dns_domain``) must give identical
text, byte for byte; the text parses as JSON and the port's
``config/options.py`` accepts it.  The engine's constructs are held the
same way on a seeded sweep of small templates, errors included.
"""
import json
import os
import random

import pytest

from binder_torch.config import options as port_options
from binder_torch.config import render as port_render
from binder_tpu.config import render as ref_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "deploy", "config", "manifest.json")

TRITON_MD = {
    "dns_domain": "dc0.example.com",
    "datacenter_name": "dc0",
    "region_name": "home",
    "ufds_domain": "ufds.dc0.example.com",
    "ufds_ldap_root_dn": "cn=root",
    "ufds_ldap_root_pw": "s&cr<t>",
    "auto": {"ZONENAME": "zone-1", "SERVER_UUID": "srv-1"},
    "SERVICE_NAME": "binder",
}

MANTA_MD = {
    "DNS_DOMAIN": "manta.example.com",
    "DATACENTER": "dc9",
    "auto": {"ZONENAME": "zone-2", "SERVER_UUID": "srv-2"},
    "SERVICE_NAME": "binder",
}


@pytest.mark.parametrize("metadata", [TRITON_MD, MANTA_MD],
                         ids=["triton", "manta"])
def test_deploy_template_renders_identically(metadata, tmp_path):
    got = port_render.render_manifest(MANIFEST, metadata, output_path=None)
    want = ref_render.render_manifest(MANIFEST, metadata, output_path=None)
    assert got == want
    cfg = json.loads(got)
    assert cfg["store"]["backend"] == "zookeeper"
    assert ("recursion" in cfg) == ("dns_domain" in metadata)
    # written through the manifest convention, the port's option parser
    # takes the file as the config layer under the CLI flags
    dest = tmp_path / "config.json"
    port_render.render_manifest(MANIFEST, metadata, output_path=str(dest))
    assert dest.read_text() == want
    opts = port_options.parse_options(["-f", str(dest), "-p", "1053"])
    assert opts["port"] == 1053
    assert opts["dnsDomain"] == cfg["dnsDomain"]
    assert opts["store"] == cfg["store"]
    assert opts.get("recursion") == cfg.get("recursion")


#: fragments the seeded sweep composes into templates
FRAGMENTS = ["{{a}}", "{{{a}}}", "{{b.c}}", "{{#s}}", "{{/s}}", "{{^s}}",
             "{{#xs}}", "{{/xs}}", "{{v}}", "{{! note\n}}", "text ", "\n",
             "&<>\"'", "{{ a }}", "{{nope}}"]

METADATA = [
    {"a": "x&y", "b": {"c": "<deep>"}, "s": True,
     "xs": [{"v": 1}, {"v": "two"}]},
    {"a": "", "s": False, "xs": []},
    {"s": {"a": "inner"}, "a": "outer", "xs": [{"a": "in-list"}]},
]


def outcome(module, template, metadata):
    try:
        return ("ok", module.render(template, metadata))
    except module.TemplateError as e:
        return ("error", str(e))


def test_engine_matches_on_seeded_templates():
    rng = random.Random(20261017)
    errors = 0
    for _ in range(400):
        template = "".join(rng.choice(FRAGMENTS)
                           for _ in range(rng.randint(1, 8)))
        for md in METADATA:
            got = outcome(port_render, template, md)
            want = outcome(ref_render, template, md)
            assert got == want, (template, md)
            errors += got[0] == "error"
    # the sweep reaches both the render and the error paths
    assert 0 < errors < 400 * len(METADATA)
