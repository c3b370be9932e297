"""Paper Tables I + II (the SAAM scenario-based evaluation, §VIII) on the
port: the 40 task probes of ``benchmarks/saam_coverage.py``, copied here
with the port's modules in place of the JAX package's
(``repro_torch.core.reporting``, ``repro_torch.core.Consortium`` and
``DataSchema``, ``repro_torch.data.make_silo_datasets``), run against a
finished ``Consortium(..., device="cpu")`` run: all 40 are direct tasks,
the paper's conclusion, as ``tests/test_saam.py`` asserts of the
reference.
"""
from __future__ import annotations

from typing import List


def _prov(md, **kw):
    return md.query(kind="provenance", **kw)


def _has_op(md, op, outcome=None):
    recs = [r for r in _prov(md) if r["operation"] == op]
    if outcome:
        recs = [r for r in recs if r["outcome"] == outcome]
    return len(recs) > 0


def build_probes() -> List[dict]:
    """Each probe: (con, run_id, node, extras) -> (ok: bool, evidence)."""
    P = []

    def add(tid, actor, task, container, fn):
        P.append({"id": tid, "actor": actor, "task": task,
                  "container": container, "probe": fn})

    md = lambda con: con.server.metadata

    add(1, "FL Participant", "Participate in the negotiation",
        "Governance and Management Website",
        lambda con, rid, node, ex: (_has_op(md(con), "vote"),
                                    "vote provenance records"))
    add(2, "FL Participant", "View FL Run history", "Reporting",
        lambda con, rid, node, ex: (
            len(__import__("repro_torch.core.reporting",
                           fromlist=["run_report"]).run_report(
                md(con), rid)["rounds"]) > 0, "run_report(rounds)"))
    add(3, "FL Participant", "Request new negotiation process",
        "Governance Manager",
        lambda con, rid, node, ex: (
            hasattr(con.server.cockpit, "request_new_negotiation"),
            "GovernanceCockpit.request_new_negotiation"))
    add(4, "FL Participant", "Request deployment of model",
        "Governance and Management Website",
        lambda con, rid, node, ex: (
            callable(getattr(con.server, "admin_force_deploy", None)),
            "FLServer.admin_force_deploy (on participant request)"))
    add(5, "FL Server Admin", "Create user accounts", "Client Management",
        lambda con, rid, node, ex: (_has_op(md(con), "create_user"),
                                    "create_user provenance"))
    add(6, "FL Server Admin", "Control the FL process", "FL Manager",
        lambda con, rid, node, ex: (
            callable(con.server.admin_resume) and callable(con.server.tick),
            "tick()/admin_resume()"))
    add(7, "FL Server Admin", "Create an FL Job", "Job Creator",
        lambda con, rid, node, ex: (
            callable(con.server.job_creator.from_admin),
            "JobCreator.from_admin"))
    add(8, "FL Server Admin", "Set up a negotiation process",
        "Governance and Management Website",
        lambda con, rid, node, ex: (con.server.cockpit is not None,
                                    "open_negotiation"))
    add(9, "FL Client Admin", "Set monitoring threshold",
        "Management Website",
        lambda con, rid, node, ex: (node.config.monitor_threshold > 0,
                                    "ClientConfig.monitor_threshold"))
    add(10, "FL Client Admin", "Set deployment threshold",
        "Management Website",
        lambda con, rid, node, ex: (node.config.deploy_threshold > 0,
                                    "ClientConfig.deploy_threshold"))
    add(11, "FL Client Admin", "Monitor the system", "Management Website",
        lambda con, rid, node, ex: (isinstance(node.monitor_history, list),
                                    "monitor_history"))
    add(12, "FL Client Admin", "Manage model endpoint", "Management Website",
        lambda con, rid, node, ex: (callable(node.predict),
                                    "Model Subscription API (predict)"))
    add(13, "FL Server", "Prepare a report", "Reporting",
        lambda con, rid, node, ex: (
            "loss_curve" in __import__("repro_torch.core.reporting",
                                       fromlist=["run_report"]).run_report(
                md(con), rid), "run_report"))
    add(14, "FL Server", "Create a FL Job from Information", "Job Creator",
        lambda con, rid, node, ex: (ex["job"].job_id.startswith("job-"),
                                    "FLJob built"))
    add(15, "FL Server", "Turn governance result to FL Job",
        "Governance Manager + Job Creator",
        lambda con, rid, node, ex: (ex["job"].contract_id is not None,
                                    "job.contract_id set"))
    add(16, "FL Server", "Store/Retrieve information", "Database Manager",
        lambda con, rid, node, ex: (len(md(con)) > 20 and
                                    len(con.server.store.list()) > 0,
                                    "MetadataStore + ModelStore"))
    add(17, "FL Server", "Run FL process", "FL Manager",
        lambda con, rid, node, ex: (ex["phase"] == "done",
                                    "run completed"))
    add(18, "FL Server", "Deploy a specific model", "Model Deployer",
        lambda con, rid, node, ex: (_has_op(md(con), "force_deploy") or
                                    callable(con.server.admin_force_deploy),
                                    "admin_force_deploy"))
    add(19, "FL Server", "Send messages to client", "Communicator",
        lambda con, rid, node, ex: (con.server.board.stats["posts"] > 0,
                                    "board posts"))
    add(20, "FL Server", "Encrypt/Compress messages", "Communicator",
        lambda con, rid, node, ex: (
            b"params" not in (con.server.board.get(
                f"runs/{rid}/job") or b"params"),
            "job resource is ciphertext"))
    add(21, "FL Server", "Authenticate client", "Client Management",
        lambda con, rid, node, ex: (
            con.server.clients.validate_token(node.client_id,
                                              node.comm.token),
            "validate_token"))
    add(22, "FL Server", "Generate device token", "Client Management",
        lambda con, rid, node, ex: (
            _has_op(md(con), "issue_token")     # per agent-lease (scheduler)
            or _has_op(md(con), "issue_tokens"),   # per-run rotation
            "device-token provenance"))
    add(23, "FL Server", "Register client", "Communicator+Client Mgmt",
        lambda con, rid, node, ex: (_has_op(md(con), "register_client"),
                                    "register_client provenance"))
    add(24, "FL Server", "Monitor FL process", "FL Manager",
        lambda con, rid, node, ex: (con.server.monitor()["phase"] == "done",
                                    "monitor()"))
    add(25, "FL Server", "Check registered clients", "Client Management",
        lambda con, rid, node, ex: (
            all(con.server.clients.check_registered(
                con.server.clients.active_clients()).values()),
            "check_registered"))
    add(26, "FL Client", "Send messages to server", "Communicator",
        lambda con, rid, node, ex: (node.round_done >= 0, "updates posted"))
    add(27, "FL Client", "Run FL Pipeline", "FL Pipeline",
        lambda con, rid, node, ex: (
            _has_op(node.metadata, "local_train"),
            "local_train provenance (validate/preprocess/train/eval)"))
    add(28, "FL Client", "Store/Retrieve information", "Database Manager",
        lambda con, rid, node, ex: (len(node.metadata) > 0,
                                    "client metadata store"))
    add(29, "FL Client", "Monitor local FL process", "Management Website",
        lambda con, rid, node, ex: (
            _has_op(node.metadata, "local_train"), "client-side tracking"))
    add(30, "FL Client", "Configure monitoring", "FL Client Model Deployer",
        lambda con, rid, node, ex: (hasattr(node.config,
                                            "monitor_threshold"),
                                    "ClientConfig"))
    add(31, "FL Client", "Configure personalization",
        "FL Client Model Deployer",
        lambda con, rid, node, ex: (node.config.personalization_steps >= 0,
                                    "personalization_steps"))
    add(32, "FL Client", "Configure model deployment",
        "FL Client Model Deployer",
        lambda con, rid, node, ex: (hasattr(node.config,
                                            "deploy_threshold"),
                                    "deploy_threshold"))
    add(33, "FL Client", "Monitor deployed model", "Model Monitoring",
        lambda con, rid, node, ex: (len(node.monitor_history) > 0,
                                    "fixed-test-set evals"))
    add(34, "FL Client", "Encrypt/Compress messages", "Communicator",
        lambda con, rid, node, ex: (True, "ClientCommunicator.post "
                                    "(same crypto path, test_communicator)"))
    add(35, "FL Client", "Perform model inference", "Inference Manager",
        lambda con, rid, node, ex: (ex["pred"].shape[1] == 2,
                                    "predict() output"))
    add(36, "FL Client", "Perform model personalization",
        "Model Personalization",
        lambda con, rid, node, ex: (
            node.deployed_digest not in (None, "rejected") and
            node.deployed_digest != ex["release_digest"],
            "personalized digest differs from release"))
    add(37, "FL Client", "Decide on model deployment", "Decision Maker",
        lambda con, rid, node, ex: (
            _has_op(node.metadata, "deploy_model"),
            "deploy_model provenance with eval vs threshold"))
    add(38, "FL Client", "Prepare report", "Database Manager/Reporting",
        lambda con, rid, node, ex: (
            len(__import__("repro_torch.core.reporting",
                           fromlist=["client_report"]).client_report(
                node.metadata, node.client_id)["trainings"]) > 0,
            "client_report"))
    add(39, "FL Client", "Trigger administrator notification",
        "FL Client Model Deployer",
        lambda con, rid, node, ex: (callable(node._notify),
                                    "notifications list"))
    add(40, "External Application", "Send inference request",
        "Model Subscription API",
        lambda con, rid, node, ex: (ex["pred"] is not None,
                                    "external predict() call"))
    return P


def run_saam(verbose: bool = True):
    """Execute the scenario evaluation against a real FL run of the
    port, on the CPU."""
    from repro_torch.core import Consortium, DataSchema
    from repro_torch.data import make_silo_datasets

    con = Consortium(["windco", "solarx", "gridpower"], seed=0, device="cpu")
    schema = DataSchema(vocab=512, seq_len=32)
    contract = con.negotiate({
        "arch": "fedforecast-100m", "rounds": 2, "local_steps": 2,
        "batch_size": 2, "lr": 1e-3, "data_schema": schema.to_dict()})
    job = con.server.job_creator.from_contract(contract)
    datasets = make_silo_datasets(3, vocab=512, seq_len=32, seed=1)
    run_id = con.start(job, datasets)
    phase = con.run_to_completion()
    node = con.nodes[0]
    # a couple of extra ticks so Model Monitoring runs post-deployment
    for _ in range(2):
        node.tick()
    release = node.comm.fetch(f"runs/{run_id}/release", broadcast=True)
    pred = node.predict(datasets[0].batch(2)["tokens"][:, :16], n_steps=2)
    extras = {"job": job, "phase": phase, "pred": pred,
              "release_digest": release["digest"]}

    rows = []
    for p in build_probes():
        try:
            ok, evidence = p["probe"](con, run_id, node, extras)
        except Exception as e:  # noqa: BLE001
            ok, evidence = False, f"probe error: {e!r}"
        rows.append({**{k: p[k] for k in ("id", "actor", "task",
                                          "container")},
                     "ok": bool(ok), "evidence": evidence})
    if verbose:
        n_ok = sum(r["ok"] for r in rows)
        print(f"SAAM scenario evaluation: {n_ok}/40 tasks pass")
        for r in rows:
            mark = "PASS" if r["ok"] else "FAIL"
            print(f"  [{mark}] {r['id']:2d} {r['actor']:22s} {r['task']:40s}"
                  f" -> {r['container']}")
    return rows



def test_all_40_saam_tasks_pass_on_the_port():
    rows = run_saam(verbose=False)
    assert len(rows) == 40
    assert sorted(r["id"] for r in rows) == list(range(1, 41))
    failures = [r for r in rows if not r["ok"]]
    assert not failures, failures
